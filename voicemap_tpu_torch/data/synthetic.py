"""A synthetic corpus in LibriSpeech's layout on disk.

Port of ``voicemap_tpu/data/synthetic.py``; the same seed writes the same
bytes (WAV or FLAC) and the same ``SPEAKERS.TXT`` as the JAX package's
``generate_corpus`` (``tests/test_torch_data_layer.py``):

    <root>/LibriSpeech/SPEAKERS.TXT                  (';'-comment header, '|'-delimited)
    <root>/LibriSpeech/<subset>/<spk>/<chap>/<spk>-<chap>-<utt:04d>.wav|.flac

Each speaker has a fixed vocal signature (fundamental, harmonic envelope,
vibrato, a coloured-noise floor and a formant), so that speaker identity is
learnable from the waveform and training on the corpus can be checked by its
n-shot accuracy. ``data/store.py :: synthetic_store`` is another, simpler
corpus that is made in memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from . import audio


@dataclass
class SyntheticSpec:
    n_speakers: int = 10
    utterances_per_speaker: int = 8
    min_seconds: float = 2.0
    max_seconds: float = 6.0
    sample_rate: int = 16000
    seed: int = 1234
    container: str = "wav"  # wav | flac
    chapters_per_speaker: int = 2


def _speaker_signature(rng: np.random.Generator) -> dict:
    """Random but per-speaker-fixed vocal parameters."""
    return {
        # Fundamental in a speech-like range; spread wide so speakers separate.
        "f0": float(rng.uniform(85.0, 360.0)),
        # Harmonic amplitude decay and comb pattern.
        "harmonic_decay": float(rng.uniform(0.55, 0.95)),
        "n_harmonics": int(rng.integers(4, 12)),
        "odd_even_ratio": float(rng.uniform(0.3, 1.0)),
        # Vibrato (f0 modulation) rate/depth.
        "vibrato_hz": float(rng.uniform(3.0, 8.0)),
        "vibrato_depth": float(rng.uniform(0.0, 0.03)),
        # Colored-noise floor: spectral tilt exponent and level.
        "noise_tilt": float(rng.uniform(0.5, 2.0)),
        "noise_level": float(rng.uniform(0.02, 0.08)),
        # Formant-ish resonance: one-pole bandpass center.
        "formant_hz": float(rng.uniform(500.0, 2500.0)),
        "sex": "M" if rng.random() < 0.5 else "F",
        "name": "SYN-" + "".join(rng.choice(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"), 6)),
    }


def _colored_noise(rng: np.random.Generator, n: int, tilt: float) -> np.ndarray:
    """1/f^tilt noise via spectral shaping."""
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    freqs = np.fft.rfftfreq(n)
    freqs[0] = freqs[1] if n > 1 else 1.0
    spec = spec / (freqs ** (tilt / 2.0))
    out = np.fft.irfft(spec, n=n)
    return (out / (np.std(out) + 1e-9)).astype(np.float64)


def synth_utterance(
    sig: dict, seconds: float, sample_rate: int, rng: np.random.Generator
) -> np.ndarray:
    """One synthetic utterance as int16 waveform with the speaker's signature."""
    n = int(round(seconds * sample_rate))
    t = np.arange(n) / sample_rate
    # Slowly varying amplitude envelope ("syllables").
    env_rate = rng.uniform(1.5, 4.0)
    env = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * env_rate * t + rng.uniform(0, np.pi)))
    # Vibrato-modulated fundamental; random phase per utterance.
    f0 = sig["f0"] * (1.0 + sig["vibrato_depth"] * np.sin(2 * np.pi * sig["vibrato_hz"] * t))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate + rng.uniform(0, 2 * np.pi)
    wave_ = np.zeros(n)
    nyq = sample_rate / 2
    for h in range(1, sig["n_harmonics"] + 1):
        if h * sig["f0"] >= nyq * 0.95:
            break
        amp = sig["harmonic_decay"] ** (h - 1)
        if h % 2 == 0:
            amp *= sig["odd_even_ratio"]
        # Formant emphasis: boost harmonics near the formant center.
        dist = abs(h * sig["f0"] - sig["formant_hz"]) / sig["formant_hz"]
        amp *= 1.0 + 1.5 * np.exp(-dist * dist * 4.0)
        wave_ += amp * np.sin(h * phase)
    wave_ /= max(np.max(np.abs(wave_)), 1e-9)
    noise = _colored_noise(rng, n, sig["noise_tilt"]) * sig["noise_level"]
    out = env * wave_ * 0.25 + noise * 0.25
    out = np.clip(out, -0.999, 0.999)
    return (out * 32767.0).astype(np.int16)


def generate_corpus(
    root: str,
    subsets: Sequence[str] = ("dev-clean",),
    spec: Optional[SyntheticSpec] = None,
) -> List[str]:
    """Write a LibriSpeech-shaped synthetic corpus; returns the written paths
    (``data/index.py`` walks ``<root>/LibriSpeech/<subset>`` and reads
    ``SPEAKERS.TXT``)."""
    spec = spec or SyntheticSpec()
    ls_root = os.path.join(root, "LibriSpeech")
    os.makedirs(ls_root, exist_ok=True)
    master = np.random.default_rng(spec.seed)
    speaker_rows = []
    paths: List[str] = []
    # Speaker ids look like LibriSpeech's (small integers, unique across subsets).
    next_spk_id = 19
    next_chap_id = 100
    for si, subset in enumerate(subsets):
        for _ in range(spec.n_speakers):
            spk_id = next_spk_id
            next_spk_id += int(master.integers(1, 9))
            sig = _speaker_signature(master)
            minutes = spec.utterances_per_speaker * (spec.min_seconds + spec.max_seconds) / 120
            speaker_rows.append(
                f"{spk_id:<4d} | {sig['sex']} | {subset:<15s} | {minutes:5.2f} | {sig['name']}"
            )
            chapters = [next_chap_id + i for i in range(spec.chapters_per_speaker)]
            next_chap_id += spec.chapters_per_speaker
            utt_rng = np.random.default_rng(spec.seed * 7919 + spk_id)
            for u in range(spec.utterances_per_speaker):
                chap = chapters[u % len(chapters)]
                seconds = float(utt_rng.uniform(spec.min_seconds, spec.max_seconds))
                data = synth_utterance(sig, seconds, spec.sample_rate, utt_rng)
                d = os.path.join(ls_root, subset, str(spk_id), str(chap))
                os.makedirs(d, exist_ok=True)
                fname = f"{spk_id}-{chap}-{u:04d}.{spec.container}"
                fpath = os.path.join(d, fname)
                if spec.container == "wav":
                    audio.write_wav(fpath, data, spec.sample_rate)
                elif spec.container == "flac":
                    from . import flac_ext

                    flac_ext.write(fpath, data, spec.sample_rate)
                else:
                    raise ValueError(spec.container)
                paths.append(fpath)
    # SPEAKERS.TXT in LibriSpeech's format: ';'-prefixed comment header, then
    # '|'-delimited rows.
    with open(os.path.join(ls_root, "SPEAKERS.TXT"), "w") as f:
        f.write("; Synthetic SPEAKERS.TXT (LibriSpeech-shaped, generated for tests)\n")
        f.write(";\n")
        f.write(";ID  |SEX| SUBSET          |MINUTES| NAME\n")
        for row in speaker_rows:
            f.write(row + "\n")
    return paths
