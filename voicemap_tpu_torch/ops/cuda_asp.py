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
versions take it.

Training: where autograd records (grad enabled and an input that needs a
gradient), ``asp_stats`` goes through an ``autograd.Function`` of its mode.
On the card its forward is the same pass (the weighted mode through an
instantiation that also writes the softmax's max and sum of each (b, c))
and its backward one more kernel pass, in ``h``'s dtype: with a the
softmax weights (1/T unweighted), μ the mean, σ the std, v = σ², g_v =
g_σ / (2σ) where σ > √eps (the variance above its floor) and 0 elsewhere,

    dh_t = a_t · (g_μ + 2 g_v (h_t − μ)),
    dlogit_t = a_t · (g_μ (h_t − μ) + g_v ((h_t − μ)² − v)).

On the CPU the same closed form in plain torch (:func:`stats_backward_reference`).
Each backward runs inside a span at the batch's rows: ``ecapa.asp_bwd``
(weighted) and ``ecapa.asp_bwd.global``. ``attentive_stats_reference`` and
``global_stats_reference`` are those plain versions: the eager PyTorch the
kernel replaced. The kernel sums in another order, so the two agree to the
f32 summation bound, not bit for bit.

The inputs: contiguous, C a multiple of 8, bf16 or f32 (``logits`` in
``h``'s dtype), on one device; any other input raises on every device.
Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises. The
launches count apart by mode: ``asp_stats.launches`` (weighted, the
training instantiation included) and ``asp_stats.global_launches``; the
backward's, both modes, ``asp_stats.backward_launches``.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import span

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


def stats_backward_reference(h: torch.Tensor, logits, mean: torch.Tensor, std: torch.Tensor,
                             g_mean, g_std) -> tuple:
    """The closed-form backward of either mode in plain torch (f32, then
    ``h``'s dtype): ``(dh, dlogits)``, dlogits None without ``logits``;
    ``g_mean``, ``g_std`` ``(B, C)`` or None for zero."""
    T = h.shape[1]
    zero = torch.zeros_like(mean)
    g_mean = zero if g_mean is None else g_mean.float()
    g_std = zero if g_std is None else g_std.float()
    g_v = torch.where(std > math.sqrt(STAT_EPS), g_std / (2.0 * std), zero)[:, None, :]
    a = (torch.softmax(logits, dim=1, dtype=torch.float32) if logits is not None
         else torch.full((1, 1, 1), 1.0 / T, device=h.device))
    d = h.float() - mean[:, None, :]
    dh = a * (g_mean[:, None, :] + 2.0 * g_v * d)
    if logits is None:
        return dh.to(h.dtype), None
    var = (std * std)[:, None, :]
    dlogits = a * (g_mean[:, None, :] * d + g_v * (d * d - var))
    return dh.to(h.dtype), dlogits.to(h.dtype)


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


def _library():
    from .._build import check, library

    return library(), check


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_kernel(h: torch.Tensor, logits, save: bool):
    """One forward launch → the outputs (and, with ``save``, the softmax's
    max and sum, each ``(B, C)`` f32)."""
    B, T, C = h.shape
    if h.data_ptr() % 16 or (logits is not None and logits.data_ptr() % 16):
        raise ValueError("asp_stats: the inputs must start on a 16-byte boundary")
    if logits is None:
        mean = torch.empty((B, C), dtype=torch.float32, device=h.device)
        std = torch.empty((B, C), dtype=torch.float32, device=h.device)
        out, ld = (mean, std), C
    else:
        pooled = torch.empty((B, 2 * C), dtype=torch.float32, device=h.device)
        mean, std, out, ld = pooled, pooled[:, C:], pooled, 2 * C
    lib, check = _library()
    bf16 = int(h.dtype == torch.bfloat16)
    with torch.cuda.device(h.device):
        if save:
            mx = torch.empty((B, C), dtype=torch.float32, device=h.device)
            total = torch.empty_like(mx)
            err = lib.vm_asp_stats_train(h.data_ptr(), logits.data_ptr(), mean.data_ptr(),
                                         std.data_ptr(), mx.data_ptr(), total.data_ptr(), B, T,
                                         C, ld, bf16, STAT_EPS, _stream(h))
        else:
            err = lib.vm_asp_stats(h.data_ptr(), None if logits is None else logits.data_ptr(),
                                   mean.data_ptr(), std.data_ptr(), B, T, C, ld, bf16,
                                   STAT_EPS, _stream(h))
    check(err, "asp_stats")
    if logits is None:
        asp_stats.global_launches += 1
    else:
        asp_stats.launches += 1
    return (out, mx, total) if save else out


def _backward(h: torch.Tensor, logits, mean, std, softmax, g_mean, g_std) -> tuple:
    """``(dh, dlogits)`` of either mode: the kernel on the card, the closed
    form on the CPU; ``softmax`` the forward's ``(max, sum)`` (weighted)."""
    with span("ecapa.asp_bwd" if logits is not None else "ecapa.asp_bwd.global", h.shape[0]):
        if h.device.type == "cpu":
            return stats_backward_reference(h, logits, mean, std, g_mean, g_std)
        B, T, C = h.shape
        dh = torch.empty_like(h)
        dlogits = torch.empty_like(logits) if logits is not None else None
        mx, total = softmax if softmax is not None else (None, None)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        g = g_mean if g_mean is not None else g_std
        ldg = g.stride(0) if g is not None else C
        lib, check = _library()
        with torch.cuda.device(h.device):
            err = lib.vm_asp_stats_bwd(ptr(h), ptr(logits), ptr(mean), ptr(std), ptr(mx),
                                       ptr(total), ptr(g_mean), ptr(g_std), ptr(dh),
                                       ptr(dlogits), B, T, C, mean.stride(0), ldg,
                                       int(h.dtype == torch.bfloat16), STAT_EPS, _stream(h))
        check(err, "asp_stats backward")
        asp_stats.backward_launches += 1
        return dh, dlogits


class _AttentiveStats(torch.autograd.Function):
    """The weighted mode under autograd: ``(h, logits)`` → ``(B, 2C)``."""

    @staticmethod
    def forward(ctx, h, logits):
        if h.device.type == "cpu":
            pooled, softmax = attentive_stats_reference(h, logits), None
        else:
            pooled, *softmax = _forward_kernel(h, logits, save=True)
        ctx.softmax = softmax
        ctx.save_for_backward(h, logits, pooled)
        return pooled

    @staticmethod
    def backward(ctx, g):
        h, logits, pooled = ctx.saved_tensors
        C = h.shape[2]
        g = g.float().contiguous()
        return _backward(h, logits, pooled[:, :C], pooled[:, C:], ctx.softmax, g[:, :C],
                         g[:, C:])


class _GlobalStats(torch.autograd.Function):
    """The unweighted mode under autograd: ``h`` → ``(mean, std)``."""

    @staticmethod
    def forward(ctx, h):
        mean, std = (global_stats_reference(h) if h.device.type == "cpu"
                     else _forward_kernel(h, None, save=False))
        ctx.save_for_backward(h, mean, std)
        return mean, std

    @staticmethod
    def backward(ctx, g_mean, g_std):
        h, mean, std = ctx.saved_tensors
        fix = lambda g: None if g is None else g.float().contiguous()  # noqa: E731
        return _backward(h, None, mean, std, None, fix(g_mean), fix(g_std))[0]


def asp_stats(h: torch.Tensor, logits: torch.Tensor = None):
    """ASP's statistics of ``h (B, T, C)``: with ``logits`` the weighted
    mean and std → ``(B, 2C)`` f32; without, the mean and std over time →
    ``(mean, std)``, each ``(B, C)`` f32. Differentiable where autograd
    records."""
    _check(h, logits)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"asp_stats: no kernel for device {h.device}")
    if torch.is_grad_enabled() and (h.requires_grad or (logits is not None
                                                        and logits.requires_grad)):
        if logits is None:
            return _GlobalStats.apply(h)
        return _AttentiveStats.apply(h, logits)
    if h.device.type == "cpu":
        if logits is None:
            return global_stats_reference(h)
        return attentive_stats_reference(h, logits)
    return _forward_kernel(h, logits, save=False)


# kernel launches; the CPU path does not count: the weighted mode, the
# unweighted, and the backward of either
asp_stats.launches = 0
asp_stats.global_launches = 0
asp_stats.backward_launches = 0
