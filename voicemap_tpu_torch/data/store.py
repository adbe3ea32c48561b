"""The decoded corpus as dense numpy arrays.

Port of ``voicemap_tpu/data/dataset.py :: AudioStore`` without pandas (the
JAX package's data modules import it, and the GPU machine has none): the same
five arrays, so a store built by either package feeds the other.
``synthetic_store`` makes one from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class AudioStore:
    """``audio`` is zero-padded int16 ``(N, T_store)``; ``lengths`` the true
    sample counts; ``labels`` contiguous class ids; ``speaker_utts`` an
    ``(S, max_utt)`` matrix of utterance ids per speaker, valid up to
    ``speaker_counts``."""

    audio: np.ndarray  # (N, T_store) int16
    lengths: np.ndarray  # (N,) int32
    labels: np.ndarray  # (N,) int32
    speaker_utts: np.ndarray  # (S, max_utt) int32
    speaker_counts: np.ndarray  # (S,) int32
    sample_rate: int
    label_names: List


def synthetic_store(seed: int, n_speakers: int, utterances_per_speaker: int,
                    min_seconds: float, max_seconds: float,
                    sample_rate: int = 16000) -> AudioStore:
    """A corpus of speaker-pitched tones in noise, made with numpy from ``seed``.

    Utterance ``u`` belongs to speaker ``u // utterances_per_speaker``; its
    length is uniform in ``[min_seconds, max_seconds]`` and the rest of its
    row is zero.
    """
    rng = np.random.default_rng(seed)
    n = n_speakers * utterances_per_speaker
    lengths = rng.integers(int(min_seconds * sample_rate),
                           int(max_seconds * sample_rate) + 1, n).astype(np.int32)
    t_store = int(lengths.max())
    pitch = rng.uniform(80.0, 300.0, n_speakers).astype(np.float32)
    t = np.arange(t_store, dtype=np.float32) / sample_rate
    labels = np.repeat(np.arange(n_speakers, dtype=np.int32), utterances_per_speaker)
    audio = np.zeros((n, t_store), np.int16)
    for u in range(n):
        phase = rng.uniform(0.0, 2.0 * np.pi)
        wave = 0.3 * np.sin(2.0 * np.pi * pitch[labels[u]] * t + phase)
        wave += 0.1 * rng.standard_normal(t_store, dtype=np.float32)
        audio[u, :lengths[u]] = (wave[:lengths[u]] * 8000.0).astype(np.int16)
    speaker_utts = np.arange(n, dtype=np.int32).reshape(n_speakers, utterances_per_speaker)
    counts = np.full(n_speakers, utterances_per_speaker, np.int32)
    return AudioStore(audio, lengths, labels, speaker_utts, counts, sample_rate,
                      list(range(n_speakers)))
