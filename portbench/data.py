"""Inputs and weights made from ``--seed``: the benchmark's general generator.

Everything here is plain torch, made on the device in a few large calls, and
a function of ``(seed, spec)`` alone, so that the program under test and the
plain reference (``reference/``) are handed the same tensors: the reference
makes them again after the window instead of keeping a copy.

- A store is LibriSpeech-shaped: ``speakers`` speakers, ``utterances`` int16
  rows at ``sample_rate``, zero-padded to the longest. Its lengths are one
  fixed set spread evenly over ``[min_seconds, max_seconds]``, which the seed
  only permutes, so every seed does the same work and holds the same bytes.
  Each row is a tone at its speaker's pitch with a random phase, in noise.
  Rows are made ``CHUNK`` at a time, each chunk from a generator of its own,
  so that any row can be made again without the others.
- A query pool is ``n`` utterances of the same speakers, ``seconds`` long.
- Weights follow an encoder's config file: He-normal convs, BatchNorm
  affines and running statistics near those of the activations they see, so
  that BatchNorm is not at its identity and the folded affine is exercised.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch

from . import counts

CHUNK = 512  # rows made by one generator
AMPLITUDE = 8000.0  # int16 units of a unit wave
TONE, NOISE = 0.3, 0.1  # amplitudes of the speaker's tone and of the noise
PITCH_HZ = (80.0, 300.0)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed``; any whole ``seed`` works."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def cpu_generator(seed: int, tag: str) -> torch.Generator:
    return torch.Generator().manual_seed(sub_seed(seed, tag))


@dataclass(frozen=True)
class StoreSpec:
    speakers: int
    utterances: int
    min_seconds: float
    max_seconds: float
    sample_rate: int = 16000

    @classmethod
    def of(cls, doc: dict) -> "StoreSpec":
        return cls(int(doc["speakers"]), int(doc["utterances"]), float(doc["min_seconds"]),
                   float(doc["max_seconds"]), int(doc.get("sample_rate", 16000)))

    @property
    def row_samples(self) -> int:
        """Samples of the longest row, the store's width."""
        return int(round(self.max_seconds * self.sample_rate))


def lengths(spec: StoreSpec, seed: int) -> torch.Tensor:
    """``(N,)`` int64 sample counts: quantiles of the uniform length
    distribution, permuted by the seed."""
    n = spec.utterances
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    fixed = torch.round((spec.min_seconds + (spec.max_seconds - spec.min_seconds) * q)
                        * spec.sample_rate).long()
    return fixed[torch.randperm(n, generator=cpu_generator(seed, "lengths"))]


def labels(spec: StoreSpec) -> torch.Tensor:
    """``(N,)`` int64 speaker of each row: rows in speaker order, counts as
    even as the totals allow."""
    return torch.repeat_interleave(torch.arange(spec.speakers), speaker_counts(spec))


def speaker_counts(spec: StoreSpec) -> torch.Tensor:
    base, extra = divmod(spec.utterances, spec.speakers)
    return torch.tensor([base + (s < extra) for s in range(spec.speakers)], dtype=torch.int64)


def pitches(spec: StoreSpec, seed: int) -> torch.Tensor:
    lo, hi = PITCH_HZ
    return lo + (hi - lo) * torch.rand(spec.speakers, generator=cpu_generator(seed, "pitch"))


def _waves(pitch_hz: torch.Tensor, n_samples: int, sample_rate: int, gen: torch.Generator,
           device) -> torch.Tensor:
    """``(R, n_samples)`` int16: tone at each row's pitch, random phase, noise."""
    rows = pitch_hz.shape[0]
    phase = 2.0 * math.pi * torch.rand(rows, generator=gen, device=device)
    noise = torch.randn(rows, n_samples, generator=gen, device=device)
    t = torch.arange(n_samples, device=device, dtype=torch.float32) / sample_rate
    wave = torch.sin((2.0 * math.pi) * pitch_hz.to(device)[:, None] * t + phase[:, None])
    return ((TONE * wave + NOISE * noise) * AMPLITUDE).to(torch.int16)


def n_chunks(spec: StoreSpec) -> int:
    return -(-spec.utterances // CHUNK)


def raw_chunk(spec: StoreSpec, seed: int, chunk: int, device) -> torch.Tensor:
    """Rows ``[chunk·CHUNK, …)`` of the store at ``sample_rate``, int16
    ``(R, row_samples)``, zero past each row's length."""
    lo = chunk * CHUNK
    hi = min(spec.utterances, lo + CHUNK)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, f"chunk{chunk}"))
    pitch = pitches(spec, seed)[labels(spec)[lo:hi]]
    rows = _waves(pitch, spec.row_samples, spec.sample_rate, gen, device)
    inside = (torch.arange(spec.row_samples, device=device)[None, :]
              < lengths(spec, seed)[lo:hi].to(device)[:, None])
    return torch.where(inside, rows, torch.zeros((), dtype=torch.int16, device=device))


def raw_windows(spec: StoreSpec, seed: int, rows: torch.Tensor, starts: torch.Tensor,
                n_samples: int, device) -> torch.Tensor:
    """``(len(rows), n_samples)`` int16: row ``rows[i]`` of the store from
    sample ``starts[i]`` on, reading zeros past the row's end."""
    rows, starts = rows.long().cpu(), starts.long().cpu()
    out = torch.zeros((rows.shape[0], n_samples), dtype=torch.int16, device=device)
    for chunk in torch.unique(rows // CHUNK).tolist():
        pick = torch.nonzero(rows // CHUNK == chunk).flatten()
        raw = raw_chunk(spec, seed, chunk, device)
        raw = torch.nn.functional.pad(raw, (0, n_samples))
        pos = starts[pick].to(device)[:, None] + torch.arange(n_samples, device=device)
        out[pick.to(device)] = raw[(rows[pick] - chunk * CHUNK).to(device)[:, None], pos]
        del raw
    return out


def query_pool(spec: StoreSpec, seed: int, n: int, seconds: float, device):
    """``(n, seconds·sample_rate)`` int16 utterances of the store's
    speakers and ``(n,)`` their speakers, made on ``device``."""
    speakers = torch.randint(0, spec.speakers, (n,), generator=cpu_generator(seed, "queries"))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "query_waves"))
    audio = _waves(pitches(spec, seed)[speakers], int(round(seconds * spec.sample_rate)),
                   spec.sample_rate, gen, device)
    return audio, speakers


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

# Mean square of a block's input: block 0 sees the whitened fragment, the
# later blocks BatchNorm's max-pooled outputs.
LATER_INPUT_MEAN_SQUARE = 1.5


def weights(config: dict, num_classes: int, seed: int, device) -> dict:
    """The encoder's and the classifier head's parameters and BatchNorm
    buffers in f32 on ``device``, by neutral names (``blocks.<i>.w`` as
    ``(cout, cin, k)``, ``.b``, ``.gamma``, ``.beta``, ``.mean``, ``.var``;
    ``embed.w``, ``embed.b``, ``head.w``, ``head.b``), from two draws."""
    enc, data = config["encoder"], config["data"]
    shapes = [(b["cin"], b["cout"], b["k"]) for b in counts.blocks(config)]
    width, dim = shapes[-1][1], enc["embedding_dim"]
    normal_sizes = [cout * cin * k + 2 * cout for cin, cout, k in shapes]
    n_normal = sum(normal_sizes) + dim * width + dim + num_classes * dim
    n_uniform = 3 * sum(cout for _, cout, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, at, au = {}, 0, 0

    def take_n(n, shape, scale):
        nonlocal at
        t = normal[at:at + n].reshape(shape) * scale
        at += n
        return t

    def take_u(n, lo, hi):
        nonlocal au
        t = lo + (hi - lo) * uniform[au:au + n]
        au += n
        return t

    for i, (cin, cout, k) in enumerate(shapes):
        mean_square = data["whiten_rms"] ** 2 if i == 0 else LATER_INPUT_MEAN_SQUARE
        sigma = math.sqrt(2.0 * mean_square)  # the conv output's spread under He init
        out[f"blocks.{i}.w"] = take_n(cout * cin * k, (cout, cin, k), math.sqrt(2.0 / (cin * k)))
        out[f"blocks.{i}.b"] = take_n(cout, (cout,), 0.1 * sigma)
        out[f"blocks.{i}.beta"] = take_n(cout, (cout,), 0.1)
        out[f"blocks.{i}.gamma"] = take_u(cout, 0.75, 1.25)
        # relu of N(0, σ²): mean σ/√(2π) ≈ 0.4σ, variance (1/2 − 1/(2π))σ² ≈ 0.34σ²
        out[f"blocks.{i}.mean"] = 0.4 * sigma * take_u(cout, 0.9, 1.1)
        out[f"blocks.{i}.var"] = 0.34 * sigma ** 2 * take_u(cout, 0.8, 1.25)
    out["embed.w"] = take_n(dim * width, (dim, width), math.sqrt(1.0 / width))
    out["embed.b"] = take_n(dim, (dim,), 0.01)
    out["head.w"] = take_n(num_classes * dim, (num_classes, dim), math.sqrt(1.0 / dim))
    out["head.b"] = torch.zeros(num_classes, device=device)
    return out
