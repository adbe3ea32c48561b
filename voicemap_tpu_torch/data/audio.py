"""Audio file probe and decode.

Port of ``voicemap_tpu/data/audio.py``: WAV through the standard library's
``wave`` and numpy, FLAC through the port's C++ decoder (``flac_ext``).
Every decode returns ``(int16 (n_samples,), sample_rate)`` for a mono file;
stereo is mean-downmixed. The float conversion (÷ 32768) happens on the
device, in the preprocessing, so the host ships compact int16.
"""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np


def probe_wav(path: str) -> Tuple[int, int]:
    """(n_samples, sample_rate) without decoding."""
    with wave.open(path, "rb") as w:
        return w.getnframes(), w.getframerate()


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a 16-bit PCM WAV file to (int16 (n,), sample_rate)."""
    with wave.open(path, "rb") as w:
        sr, n, ch, sw = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if sw != 2:
        raise ValueError(f"{path}: only 16-bit PCM WAV supported, got width {sw}")
    data = np.frombuffer(raw, dtype="<i2")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1).astype(np.int16)
    return data, sr


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write mono int16 PCM WAV."""
    data = np.asarray(data)
    if data.dtype != np.int16:
        raise ValueError("write_wav expects int16")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(data.tobytes())


def probe(path: str) -> Tuple[int, int]:
    """(n_samples, sample_rate) for any supported container."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return probe_wav(path)
    if ext == ".flac":
        from . import flac_ext

        return flac_ext.probe(path)
    raise ValueError(f"unsupported audio container: {path}")


def read(path: str) -> Tuple[np.ndarray, int]:
    """Decode any supported container to (int16 (n,), sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext == ".flac":
        from . import flac_ext

        return flac_ext.read(path)
    raise ValueError(f"unsupported audio container: {path}")


def to_float(x: np.ndarray) -> np.ndarray:
    """int16 → float32 in [-1, 1), divided by 2**15."""
    return np.asarray(x, dtype=np.float32) / 32768.0
