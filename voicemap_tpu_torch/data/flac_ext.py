"""ctypes bindings for the port's C++ FLAC decoder.

Port of ``voicemap_tpu/data/flac_ext.py``. The decoder source is the port's
own copy, ``flac/flac_decoder.cpp``; at first use it is built with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into ``build/flac/`` at the
repository root (ignored by git, beside ``_build.py``'s ``build/kernels``),
under a name that carries the source's digest, so that an edited source
builds anew. The build writes a temporary file and renames it into place
under a lock, so that test workers and the pipeline's producer thread never
load a half-written library.

- ``probe(path)`` → (n_samples, sample_rate), from STREAMINFO only;
- ``read(path)`` → (int16 (n,), sample_rate), stereo mean-downmixed;
- ``read_batch(paths, n_threads)`` → the files decoded by C++ threads with
  the GIL released once for the batch (the streaming pipeline's decode);
- ``write(path, data, sample_rate)`` through the pure-Python encoder
  (``flac_enc``), for tests and the synthetic corpus.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "flac" / "flac_decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "flac"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the decoder of this source is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libvmflac_{digest}.so"


def build(force: bool = False) -> Path:
    """Compile the decoder if it is not built yet; returns the library's path."""
    target = library_path()
    with _lock:
        if target.exists() and not force:
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:  # other processes
            fcntl.flock(lock, fcntl.LOCK_EX)
            if target.exists() and not force:
                return target
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                                str(SOURCE), "-o", tmp], check=True, capture_output=True)
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.vm_flac_probe.restype = ctypes.c_int
    lib.vm_flac_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.vm_flac_decode.restype = ctypes.c_int64
    lib.vm_flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.vm_flac_decode_batch.restype = ctypes.c_int
    lib.vm_flac_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.vm_flac_last_error.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _error(lib) -> str:
    return lib.vm_flac_last_error().decode("utf-8", "replace")


def _probe_full(path: str) -> Tuple[int, int, int]:
    """(n_samples_per_channel, sample_rate, channels) from STREAMINFO only."""
    lib = _load()
    n, sr, ch, bps = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.vm_flac_probe(path.encode(), ctypes.byref(n), ctypes.byref(sr),
                           ctypes.byref(ch), ctypes.byref(bps))
    if rc != 0:
        raise IOError(f"FLAC probe failed for {path}: {_error(lib)}")
    return int(n.value), int(sr.value), int(ch.value)


def probe(path: str) -> Tuple[int, int]:
    """(n_samples_per_channel, sample_rate) from STREAMINFO only."""
    n, sr, _ = _probe_full(path)
    return n, sr


def _downmix(data: np.ndarray, nch: int) -> np.ndarray:
    if nch > 1:
        return data.reshape(-1, nch).mean(axis=1).astype(np.int16)
    return data


def read(path: str) -> Tuple[np.ndarray, int]:
    """Decode to (int16 (n,), sample_rate); stereo is mean-downmixed."""
    lib = _load()
    n_samples, _ = probe(path)
    # STREAMINFO's total may be 0 (unknown): then room for ten minutes.
    cap_per_ch = n_samples if n_samples > 0 else 16000 * 60 * 10
    buf = np.empty(cap_per_ch * 8, dtype=np.int16)  # up to 8 channels
    sr, ch = ctypes.c_int(), ctypes.c_int()
    got = lib.vm_flac_decode(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                             buf.size, ctypes.byref(sr), ctypes.byref(ch))
    if got < 0:
        raise IOError(f"FLAC decode failed for {path}: {_error(lib)}")
    nch = int(ch.value)
    data = buf[: got * nch]
    return (_downmix(data, nch) if nch > 1 else data.copy()), int(sr.value)


def read_batch(paths: Sequence[str], n_threads: int = 0) -> List[np.ndarray]:
    """Decode many files in C++ threads, the GIL released once.

    Multi-channel files are mean-downmixed as ``read`` does, so the choice
    between the two never changes the waveform a file yields.
    """
    lib = _load()
    n = len(paths)
    bufs = []
    caps = np.empty(n, dtype=np.int64)
    for i, p in enumerate(paths):
        ns, _, nch = _probe_full(p)
        # interleaved int16 slots, twice over for streams whose STREAMINFO undercounts
        cap = (ns if ns > 0 else 16000 * 600) * max(1, nch) * 2
        bufs.append(np.empty(cap, dtype=np.int16))
        caps[i] = cap
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_int16) * n)(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for b in bufs])
    lens = np.empty(n, dtype=np.int64)
    chans = np.empty(n, dtype=np.int32)
    rc = lib.vm_flac_decode_batch(
        c_paths, n, c_outs, caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        chans.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), int(n_threads))
    if rc != 0:
        bad = [paths[i] for i in range(n) if lens[i] < 0]
        raise IOError(f"FLAC batch decode failed for {bad[:3]}{'…' if len(bad) > 3 else ''}: "
                      f"{_error(lib)}")
    return [_downmix(bufs[i][: int(lens[i]) * int(chans[i])], int(chans[i]))
            for i in range(n)]


def write(path: str, data: np.ndarray, sample_rate: int, **kw) -> None:
    """Encode mono int16 → FLAC with the pure-Python encoder."""
    from . import flac_enc

    flac_enc.encode_file(path, data, sample_rate, **kw)
