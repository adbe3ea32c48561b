"""ASP: the reductions over time of ECAPA-TDNN's attentive statistics
pooling (``models/ecapa.py``), one pass over ``h`` in ``csrc/asp_stats.cu``.

ECAPA-TDNN is the port's own configuration, so the kernel replaces no TPU
kernel. Its two modes, over ``h (B, T, C)`` per utterance and channel:

- weighted (``asp_stats(h, logits)``): the softmax over time of ``logits``
  (``h``'s shape), then the weighted mean and std of ``h`` → ``(B, 2C)``
  f32, ``[mean, std]``. The kernel keeps an online softmax in f32 (a
  running max, Σe, Σe·h and Σe·h², rescaled when the max rises);
- unweighted (``asp_stats(h)``): the mean and std of ``h`` over time → two
  ``(B, C)`` f32 tensors.

Both read each byte of their inputs once and write only the statistics;
std = sqrt(max(E[h²] − mean², ``STAT_EPS``)), in f32, as the plain
versions take it. ``attentive_stats_reference`` and
``global_stats_reference`` are those plain versions: the eager PyTorch the
kernel replaced. The kernel sums in another order, so the two agree to the
f32 summation bound, not bit for bit.

The inputs: contiguous, C a multiple of 8, bf16 or f32 (``logits`` in
``h``'s dtype), on one device; any other input raises on every device.
Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises, as
does a CUDA input that needs a gradient (the kernel has no backward;
ECAPA-TDNN only embeds). The launches count apart by mode:
``asp_stats.launches`` (weighted) and ``asp_stats.global_launches``.
"""

from __future__ import annotations

import torch

STAT_EPS = 1e-12  # SpeechBrain's floor under a variance before its square root
_DTYPES = (torch.float32, torch.bfloat16)


def asp_stats_bytes(B: int, T: int, C: int, itemsize: int, weighted: bool) -> int:
    """What a call must move, for its bound: ``h`` (and the logits) read
    once, ``2·B·C`` f32 statistics written once."""
    return (2 if weighted else 1) * B * T * C * itemsize + 2 * B * C * 4


def global_stats_reference(h: torch.Tensor) -> tuple:
    """Mean and std over time of ``(B, T, C)``, each ``(B, C)`` f32."""
    mean = h.mean(dim=1, dtype=torch.float32)
    square = torch.linalg.vector_norm(h, dim=1, dtype=torch.float32).square_() / h.shape[1]
    return mean, (square - mean * mean).clamp_(min=STAT_EPS).sqrt_()


def attentive_stats_reference(h: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Softmax over time per channel, then the weighted mean and std of
    ``h`` → ``(B, 2C)`` f32."""
    w = torch.softmax(logits, dim=1, dtype=torch.float32)
    wh = w.mul_(h)
    mean = wh.sum(dim=1)
    square = wh.mul_(h).sum(dim=1)
    return torch.cat([mean, (square - mean * mean).clamp_(min=STAT_EPS).sqrt_()], dim=1)


def _check(h: torch.Tensor, logits) -> None:
    for name, t in (("h", h), ("logits", logits)):
        if t is None:
            continue
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"asp_stats: {name} must be a contiguous (B, T, C) tensor, got "
                             f"shape {tuple(t.shape)}, strides {tuple(t.stride())}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"asp_stats: {name} must be float32 or bfloat16, got {t.dtype}")
    B, T, C = h.shape
    if B < 1 or T < 1 or C < 8 or C % 8:
        raise ValueError(f"asp_stats: B and T must be at least 1 and C a multiple of 8, got "
                         f"{(B, T, C)}")
    if logits is not None and (logits.shape != h.shape or logits.dtype != h.dtype
                               or logits.device != h.device):
        raise ValueError(f"asp_stats: logits must be {tuple(h.shape)} {h.dtype} on {h.device}, "
                         f"got {tuple(logits.shape)} {logits.dtype} on {logits.device}")


def asp_stats(h: torch.Tensor, logits: torch.Tensor = None):
    """ASP's statistics of ``h (B, T, C)``: with ``logits`` the weighted
    mean and std → ``(B, 2C)`` f32; without, the mean and std over time →
    ``(mean, std)``, each ``(B, C)`` f32."""
    _check(h, logits)
    if h.device.type == "cpu":
        if logits is None:
            return global_stats_reference(h)
        return attentive_stats_reference(h, logits)
    if h.device.type != "cuda":
        raise ValueError(f"asp_stats: no kernel for device {h.device}")
    B, T, C = h.shape
    if h.data_ptr() % 16 or (logits is not None and logits.data_ptr() % 16):
        raise ValueError("asp_stats: the inputs must start on a 16-byte boundary")
    if torch.is_grad_enabled() and (h.requires_grad or (logits is not None
                                                        and logits.requires_grad)):
        raise ValueError("asp_stats: the kernel has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if logits is None:
        mean = torch.empty((B, C), dtype=torch.float32, device=h.device)
        std = torch.empty((B, C), dtype=torch.float32, device=h.device)
        out, ld = (mean, std), C
    else:
        pooled = torch.empty((B, 2 * C), dtype=torch.float32, device=h.device)
        mean, std, out, ld = pooled, pooled[:, C:], pooled, 2 * C
    from .._build import check, library

    with torch.cuda.device(h.device):
        err = library().vm_asp_stats(
            h.data_ptr(), None if logits is None else logits.data_ptr(), mean.data_ptr(),
            std.data_ptr(), B, T, C, ld, int(h.dtype == torch.bfloat16), STAT_EPS,
            torch.cuda.current_stream().cuda_stream)
    check(err, "asp_stats")
    if logits is None:
        asp_stats.global_launches += 1
    else:
        asp_stats.launches += 1
    return out


# kernel launches; the CPU path does not count: the weighted mode, the unweighted
asp_stats.launches = 0
asp_stats.global_launches = 0
