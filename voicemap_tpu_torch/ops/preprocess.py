"""Fragment gather, stride decimation, whitening and offset sampling.

Port of ``voicemap_tpu/ops/preprocess.py`` (``whiten``, ``stride_decimate``,
``extract_fragments``, ``preprocess_batch``, ``gather_fragments``,
``sample_offsets``), in plain torch ops, as the JAX package writes them in
``jnp``; the store path's fused version is the B1 kernel
(``ops/cuda_preprocess``). The same semantics:

- int16 -> float32 as x / 32768;
- stride decimation ``x[:, ::d]``, with no anti-alias filter;
- whitening: per-fragment zero mean, then the demeaned signal rescaled to a
  fixed RMS (default 0.038021), with an epsilon guard.

Random offsets come from an explicit ``torch.Generator``. It cannot replay the
JAX package's threefry stream, so the two packages draw different offsets from
the same seed; the tests hand both the same offsets.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DEFAULT_WHITEN_RMS

INT16_SCALE = 1.0 / 32768.0


def whiten(batch: torch.Tensor, rms: float = DEFAULT_WHITEN_RMS,
           eps: float = 1e-8) -> torch.Tensor:
    """Zero-mean + fixed-RMS rescale per fragment; (B, T) or (B, T, 1)."""
    mean = batch.mean(dim=1, keepdim=True)
    centered = batch - mean
    cur_rms = centered.square().mean(dim=1, keepdim=True).sqrt()
    return centered * (rms / (cur_rms + eps))


def stride_decimate(batch: torch.Tensor, downsampling: int) -> torch.Tensor:
    """Naive stride decimation along the time axis (axis 1)."""
    if downsampling == 1:
        return batch
    return batch[:, ::downsampling]


def extract_fragments(audio: torch.Tensor, offsets: torch.Tensor,
                      fragment_length: int) -> torch.Tensor:
    """``out[b] = audio[b, offsets[b] : offsets[b] + fragment_length]`` of
    rows already gathered ``(B, T_store)``; the caller keeps every window
    inside the row."""
    pos = offsets.long()[:, None] + torch.arange(fragment_length, device=audio.device)
    return torch.gather(audio, 1, pos)


def preprocess_batch(audio_rows: torch.Tensor, offsets: torch.Tensor, fragment_length: int,
                     downsampling: int, whiten_rms: Optional[float] = DEFAULT_WHITEN_RMS,
                     whiten_eps: float = 1e-8) -> torch.Tensor:
    """Fragment gather, decimation and whitening → ``(B, T_model, 1)`` f32.

    ``audio_rows`` is int16 (÷ 32768 here) or float.
    """
    frags = extract_fragments(audio_rows, offsets, fragment_length)
    if frags.dtype == torch.int16:
        frags = frags.float() * INT16_SCALE
    else:
        frags = frags.float()
    frags = stride_decimate(frags, downsampling)
    if whiten_rms is not None:
        frags = whiten(frags, whiten_rms, whiten_eps)
    return frags[..., None]


def gather_fragments(store: torch.Tensor, indices: torch.Tensor,
                     offsets: torch.Tensor, fragment_length: int) -> torch.Tensor:
    """``out[b] = store[indices[b], offsets[b] : offsets[b] + fragment_length]``.

    Reads only the fragment of each row. The caller keeps every window inside
    the row (``offsets[b] + fragment_length <= store.shape[1]``).
    """
    pos = offsets.long()[:, None] + torch.arange(fragment_length, device=store.device)
    return store[indices.long()[:, None], pos]


def sample_offsets(lengths: torch.Tensor, fragment_length: int,
                   generator: Optional[torch.Generator] = None,
                   stochastic: bool = True) -> torch.Tensor:
    """Random (or zero) int32 fragment starts in ``[0, max(len - frag, 0)]``.

    The uniform draws come from ``generator`` on its own device and are moved
    to ``lengths``' device.
    """
    if not stochastic:
        return torch.zeros_like(lengths, dtype=torch.int32)
    max_start = (lengths - fragment_length).clamp(min=0)
    gen_device = generator.device if generator is not None else lengths.device
    u = torch.rand(lengths.shape, generator=generator, device=gen_device)
    u = u.to(lengths.device)
    return (u * (max_start + 1).float()).to(torch.int32)
