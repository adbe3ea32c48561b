"""B4 and B5: the encoder's block 0 in training, forward and backward cores.

Port of ``voicemap_tpu/ops/pallas_conv_train.py :: pallas_fwd_core`` (B4) and
``pallas_bwd_core`` (B5). Both kernels live in ``csrc/conv_block0_train.cu``;
``conv_block0_train_reference`` and ``conv_block0_train_bwd_reference`` are
their plain PyTorch versions, ports of ``voicemap_tpu/ops/conv_train.py ::
_xla_fwd_core`` and ``_xla_bwd_core`` with the Pallas kernels' rounding.

Semantics shared by kernel and plain version, each pinned by a test:

- the SAME conv (k=32, 15 zeros left, 16 right) of ``x`` and ``w`` rounded
  to ``gemm_dtype``, its taps summed in order k = 0 … 31 in f32, then
  ``a = relu(y + bias)``;
- ``a_sel = s · max_j(s · a_j)`` over the 4 pool phases, ``s = sgn`` (±1,
  the sign of the BatchNorm scale), rounded once to ``sel_dtype``;
- forward statistics Σa, Σa² and #(a > 0) per channel over all B·T
  positions, in f32;
- backward: ``g`` rounded to ``gemm_dtype``, routed to the first phase in
  time order whose ``s · a_j`` is the max; ``dz = 1[a>0]·((c0·g + c1) + c2·a)``
  op by op in f32; ``db = Σ dz`` in f32; ``dz`` rounded to ``gemm_dtype``
  for ``dW[k, c] = Σ x[t + k − 15]·dz[t, c]``.

The TPU kernel stacked its weight gradient by pool phase (``dW4``) and
un-stacked it in the wrapper; that was its GEMM's layout and has no
counterpart here: both versions return ``dw (32, 1, C)`` directly.

Layouts are the JAX package's: ``x (B, T, 1)`` f32, ``w (k, 1, C)``,
``a_sel`` and ``g`` ``(B, T/4, C)``. T must divide by 4 (the block-0 op falls
back to the plain block otherwise). Dispatch is by the input's device: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (k=32,
pool 4, C ≤ 256), and a failed build or launch raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_TAPS = 32
KERNEL_POOL = 4
MAX_CHANNELS = 256  # one thread per channel
TILE = 128  # pooled outputs per tile, as in the kernel
MAX_CTAS = 1056  # fixed: every shape maps its tiles to CTAs the same way each run
_DTYPES = (torch.float32, torch.bfloat16)


def _activation(x, w, b, gemm_dtype):
    """``relu(conv_same(x, w) + b)`` → ``(B, C, T)`` f32, taps in order."""
    if x.dim() == 3:
        x = x[..., 0]
    B, T = x.shape
    k, _, c = w.shape
    xp = F.pad(x.to(gemm_dtype).float(), ((k - 1) // 2, k // 2))
    wq = w[:, 0, :].to(gemm_dtype).float()
    y = torch.zeros((B, c, T), dtype=torch.float32, device=x.device)
    for j in range(k):
        y += xp[:, None, j:j + T] * wq[j][:, None]
    return torch.relu(y + b.float()[:, None]), xp


def conv_block0_train_reference(x, w, b, sgn, pool: int = KERNEL_POOL,
                                 gemm_dtype=torch.bfloat16, sel_dtype=torch.bfloat16):
    """Plain PyTorch version of B4 → ``(a_sel (B, T/pool, C), Σa, Σa², #(a>0))``."""
    a, _ = _activation(x, w, b, gemm_dtype)
    B, c, T = a.shape
    s = sgn.float()
    best = (a.view(B, c, T // pool, pool) * s[None, :, None, None]).amax(-1)
    a_sel = (best * s[None, :, None]).to(sel_dtype).transpose(1, 2).contiguous()  # as B4 lays it
    return (a_sel, a.sum((0, 2)), (a * a).sum((0, 2)), (a > 0).float().sum((0, 2)))


def conv_block0_train_bwd_reference(x, w, b, sgn, g, c0, c1, c2, pool: int = KERNEL_POOL,
                                    gemm_dtype=torch.bfloat16):
    """Plain PyTorch version of B5 → ``(dw (k, 1, C) f32, db (C,) f32)``."""
    a, xp = _activation(x, w, b, gemm_dtype)
    B, c, T = a.shape
    k = w.shape[0]
    ar = a.view(B, c, T // pool, pool)
    sa = ar * sgn.float()[None, :, None, None]
    eq = sa == sa.amax(-1, keepdim=True)
    first = eq & (eq.cumsum(-1) == 1)
    gv = g.to(gemm_dtype).float().transpose(1, 2)[..., None]  # (B, C, T/pool, 1)
    gj = torch.where(first, gv, 0.0)
    col = lambda v: v.float()[None, :, None, None]  # noqa: E731
    dz = col(c0) * gj + col(c1) + col(c2) * ar
    dz = torch.where(ar > 0, dz, 0.0).view(B, c, T)
    db = dz.sum((0, 2))
    dzr = dz.to(gemm_dtype).float()
    dw = torch.stack([torch.einsum("bt,bct->c", xp[:, j:j + T], dzr) for j in range(k)])
    return dw[:, None, :], db


def _check(name, x, w, pool, gemm_dtype, *params):
    if x.dim() == 3:
        if x.shape[-1] != 1:
            raise ValueError(f"{name}: the kernel is Cin=1 only")
        x = x[..., 0]
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be a (B, T[, 1]) float32 tensor")
    k, cin, c = w.shape
    if (k, cin, pool) != (KERNEL_TAPS, 1, KERNEL_POOL):
        raise ValueError(f"{name}: the kernel takes k={KERNEL_TAPS}, Cin=1, pool={KERNEL_POOL}; "
                         f"got k={k}, Cin={cin}, pool={pool}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"{name}: at most {MAX_CHANNELS} channels, got {c}")
    B, T = x.shape
    if T % pool or T < pool or B < 1:
        raise ValueError(f"{name}: T={T} must be a positive multiple of {pool}")
    if gemm_dtype not in _DTYPES:
        raise ValueError(f"{name}: gemm_dtype must be float32 or bfloat16")
    if any(p.device != x.device for p in (w, *params)):
        raise ValueError(f"{name}: every tensor must lie on {x.device}")
    tiles = B * -(-(T // pool) // TILE)
    return x.contiguous(), w[:, 0, :].to(gemm_dtype).float().contiguous(), min(tiles, MAX_CTAS)


def conv_block0_train(x, w, b, sgn, pool: int = KERNEL_POOL, gemm_dtype=torch.bfloat16,
                      sel_dtype=torch.bfloat16):
    """B4: ``(a_sel (B, T/pool, C) sel_dtype, Σa, Σa², #(a>0))``, stats ``(C,)`` f32."""
    if x.device.type == "cpu":
        return conv_block0_train_reference(x, w, b, sgn, pool, gemm_dtype, sel_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block0_train: no kernel for device {x.device}")
    x2, wk, n_ctas = _check("conv_block0_train", x, w, pool, gemm_dtype, b, sgn)
    if sel_dtype not in _DTYPES:
        raise ValueError("conv_block0_train: sel_dtype must be float32 or bfloat16")
    B, T = x2.shape
    c = w.shape[2]
    sel = torch.empty((B, T // pool, c), dtype=sel_dtype, device=x.device)
    part = torch.empty((n_ctas, 3, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((3, c), dtype=torch.float32, device=x.device)
    bias, sg = b.float().contiguous(), sgn.float().contiguous()
    from .._build import check, library

    with torch.cuda.device(x.device):
        err = library().vm_block0_train_fwd(
            x2.data_ptr(), wk.data_ptr(), bias.data_ptr(), sg.data_ptr(), sel.data_ptr(),
            part.data_ptr(), stats.data_ptr(), B, T, c, n_ctas,
            int(gemm_dtype == torch.bfloat16), int(sel_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check(err, "conv_block0_train")
    conv_block0_train.launches += 1
    return sel, stats[0], stats[1], stats[2]


def conv_block0_train_bwd(x, w, b, sgn, g, c0, c1, c2, pool: int = KERNEL_POOL,
                          gemm_dtype=torch.bfloat16):
    """B5: ``(dw (k, 1, C) f32, db (C,) f32)`` for the pooled cotangent ``g``."""
    if x.device.type == "cpu":
        return conv_block0_train_bwd_reference(x, w, b, sgn, g, c0, c1, c2, pool, gemm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block0_train_bwd: no kernel for device {x.device}")
    x2, wk, n_ctas = _check("conv_block0_train_bwd", x, w, pool, gemm_dtype, b, sgn, g,
                            c0, c1, c2)
    B, T = x2.shape
    c = w.shape[2]
    if g.shape != (B, T // pool, c):
        raise ValueError(f"conv_block0_train_bwd: g must be {(B, T // pool, c)}, got "
                         f"{tuple(g.shape)}")
    gq = g.to(gemm_dtype).contiguous()
    cc = torch.stack([c0.float(), c1.float(), c2.float()]).contiguous()
    bias, sg = b.float().contiguous(), sgn.float().contiguous()
    part = torch.empty((n_ctas, KERNEL_TAPS + 1, c), dtype=torch.float32, device=x.device)
    out = torch.empty((KERNEL_TAPS + 1, c), dtype=torch.float32, device=x.device)
    from .._build import check, library

    with torch.cuda.device(x.device):
        err = library().vm_block0_train_bwd(
            x2.data_ptr(), wk.data_ptr(), bias.data_ptr(), sg.data_ptr(), gq.data_ptr(),
            cc.data_ptr(), part.data_ptr(), out.data_ptr(), B, T, c, n_ctas,
            int(gemm_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    check(err, "conv_block0_train_bwd")
    conv_block0_train_bwd.launches += 1
    return out[:KERNEL_TAPS, None, :], out[KERNEL_TAPS]


conv_block0_train.launches = 0  # kernel launches; the CPU path does not count
conv_block0_train_bwd.launches = 0
