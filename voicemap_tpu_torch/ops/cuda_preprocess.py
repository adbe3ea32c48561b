"""B1: fused fragment gather + whiten over a pre-decimated int16 store.

Port of ``voicemap_tpu/ops/pallas_preprocess.py`` (``decimate_store``,
``pallas_gather_whiten``). The kernel is ``csrc/gather_whiten.cu``;
``gather_whiten_reference`` is its plain PyTorch version, which the CPU tests
hold against the Pallas kernel and the GPU smoke run holds against the CUDA
kernel.

Semantics shared by both: row ``b`` is ``frag`` samples of utterance
``indices[b]`` from sample ``offsets[b]`` on (decimated units); a sample
outside the stored row reads as 0 (the silence of the JAX store's zero pad);
the result is ÷32768 and, unless ``whiten_rms`` is None, whitened with its
statistics over exactly those ``frag`` samples.

Dispatch is by the store's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import DEFAULT_WHITEN_RMS
from .preprocess import INT16_SCALE, whiten

# Dynamic shared memory holds one int16 row; Hopper gives a block 227 KB.
MAX_FRAGMENT = 100_000


def decimate_store(store: torch.Tensor, downsampling: int) -> torch.Tensor:
    """One-time stride decimation of the raw ``(N, T)`` int16 store."""
    if downsampling == 1:
        return store.contiguous()
    return store[:, ::downsampling].contiguous()


def gather_whiten_reference(
    store: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor,
    fragment_length: int,
    whiten_rms: Optional[float] = DEFAULT_WHITEN_RMS,
    whiten_eps: float = 1e-8,
) -> torch.Tensor:
    """Plain PyTorch version of the B1 kernel → ``(B, fragment_length)`` f32."""
    t_store = store.shape[1]
    pos = offsets.long()[:, None] + torch.arange(fragment_length, device=store.device)
    inside = (pos >= 0) & (pos < t_store)
    rows = store[indices.long()[:, None], pos.clamp(0, t_store - 1)]
    x = torch.where(inside, rows, 0).float() * INT16_SCALE
    return x if whiten_rms is None else whiten(x, whiten_rms, whiten_eps)


def gather_whiten(
    store: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor,
    fragment_length: int,
    whiten_rms: Optional[float] = DEFAULT_WHITEN_RMS,
    whiten_eps: float = 1e-8,
) -> torch.Tensor:
    """Fused gather(+whiten) → ``(B, fragment_length)`` float32.

    ``store`` is ``(N, T)`` int16 (from :func:`decimate_store`), ``indices``
    and ``offsets`` are ``(B,)`` int32. On CUDA an index outside ``[0, N)``
    yields a NaN row instead of a read outside the store.
    """
    if store.device.type == "cpu":
        return gather_whiten_reference(store, indices, offsets, fragment_length,
                                       whiten_rms, whiten_eps)
    if store.device.type != "cuda":
        raise ValueError(f"gather_whiten: no kernel for device {store.device}")
    if store.dtype != torch.int16 or store.dim() != 2 or not store.is_contiguous():
        raise ValueError("gather_whiten: store must be a contiguous (N, T) int16 tensor")
    B = indices.shape[0]
    for name, t in (("indices", indices), ("offsets", offsets)):
        if (t.dtype != torch.int32 or t.shape != (B,) or t.device != store.device
                or not t.is_contiguous()):
            raise ValueError(
                f"gather_whiten: {name} must be a contiguous (B,) int32 tensor "
                f"on {store.device}")
    if not 0 < fragment_length <= MAX_FRAGMENT:
        raise ValueError(f"gather_whiten: fragment_length must lie in (0, {MAX_FRAGMENT}]")
    from .._build import check, library

    lib = library()
    out = torch.empty((B, fragment_length), dtype=torch.float32, device=store.device)
    with torch.cuda.device(store.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vm_gather_whiten(
            store.data_ptr(), store.shape[0], store.shape[1],
            indices.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            B, fragment_length,
            ctypes.c_float(whiten_rms if whiten_rms is not None else 0.0),
            ctypes.c_float(whiten_eps), int(whiten_rms is not None), stream,
        )
    check(err, "gather_whiten")
    gather_whiten.launches += 1
    return out


gather_whiten.launches = 0  # kernel launches; the CPU path does not count
