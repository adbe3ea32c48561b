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
tensor takes the plain version, a CUDA tensor launches a kernel (k=32,
pool 4, C ≤ 256), and a failed build or launch raises. Each kernel has two
routes on the tensor cores (host side ``ops/block0_train_tc``), chosen by
``gemm_dtype``: a bf16 GEMM (the train step in bf16; ``mma.sync``), counted
on ``launches``, and a float32 GEMM, counted on ``f32_launches``, whose
products run in 3xTF32 (``csrc/tf32x3.cuh``, plain model ``ops/tf32x3``;
the conv on ``wgmma``, B5's dW on ``mma.sync``), as the TPU kernel ran its
f32 product at the 'highest' precision on its matrix unit. Both routes' f32 sums agree with the
plain version (products and sums rounded apart, in tap order) to an order
bound, their #(a > 0) and routing flip only within it, and their
statistics, dW and db agree to an f32 sum-order tolerance.
``conv_block0_train_bwd_stage`` is B5's kernel also writing what it
recomputed (on no path: a check holds it to B4's f32 ``a_sel``), and
``conv_block0_train_bwd_routed_reference`` the plain dW and db on the
routes and relu masks it reports.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import block0_train_tc

KERNEL_TAPS = 32
KERNEL_POOL = 4
MAX_CHANNELS = 256  # the widest block 0 the kernels take (two bf16 channel groups)
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


def bwd_dz(x, w, b, sgn, g, c0, c1, c2, pool: int = KERNEL_POOL, gemm_dtype=torch.bfloat16,
           route=None, relu=None):
    """B5's ``dz (B, C, T)`` f32 before its rounding to ``gemm_dtype``, and
    the padded ``x`` rounded to it, ``(B, T + k − 1)``: the cotangent routed
    to the first phase whose ``s·a_j`` is the max and dz kept where ``a > 0``,
    or, where given, routed to ``route (B, T/pool, C)`` and kept where bit j
    of ``relu (B, T/pool, C)`` is set (the stage entry's reports)."""
    a, xp = _activation(x, w, b, gemm_dtype)
    B, c, T = a.shape
    ar = a.view(B, c, T // pool, pool)
    if route is None:
        sa = ar * sgn.float()[None, :, None, None]
        eq = sa == sa.amax(-1, keepdim=True)
        first, active = eq & (eq.cumsum(-1) == 1), ar > 0
    else:
        phase = torch.arange(pool, device=a.device)
        first = route.transpose(1, 2).long()[..., None] == phase  # (B, C, T/pool, pool)
        active = (relu.transpose(1, 2).long()[..., None] >> phase) & 1 == 1
    gv = g.to(gemm_dtype).float().transpose(1, 2)[..., None]  # (B, C, T/pool, 1)
    gj = torch.where(first, gv, 0.0)
    col = lambda v: v.float()[None, :, None, None]  # noqa: E731
    dz = col(c0) * gj + col(c1) + col(c2) * ar
    return torch.where(active, dz, 0.0).reshape(B, c, T), xp


def _dw_db(dz, xp, k: int, gemm_dtype):
    T = dz.shape[2]
    db = dz.sum((0, 2))
    dzr = dz.to(gemm_dtype).float()
    dw = torch.stack([torch.einsum("bt,bct->c", xp[:, j:j + T], dzr) for j in range(k)])
    return dw[:, None, :], db


def conv_block0_train_bwd_reference(x, w, b, sgn, g, c0, c1, c2, pool: int = KERNEL_POOL,
                                    gemm_dtype=torch.bfloat16):
    """Plain PyTorch version of B5 → ``(dw (k, 1, C) f32, db (C,) f32)``."""
    dz, xp = bwd_dz(x, w, b, sgn, g, c0, c1, c2, pool, gemm_dtype)
    return _dw_db(dz, xp, w.shape[0], gemm_dtype)


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
    return x.contiguous()


def _tc_grid(name, x, c, kind, out_bytes=2):
    """The tensor-core route's ``(tile, n_cps, CTAs)``; raises for a width
    whose CTA does not fit shared memory."""
    B, T = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, n_cps = block0_train_tc.grid(B, T, c, kind, sms)
    need = block0_train_tc.smem_bytes(c, tile, kind, out_bytes)
    if need > block0_train_tc.SMEM_LIMIT:
        raise ValueError(f"{name}: C = {c} needs {need} bytes of shared memory a CTA, over "
                         f"{block0_train_tc.SMEM_LIMIT}")
    return tile, n_cps, n_cps * block0_train_tc.channel_groups(c, kind)


def conv_block0_train(x, w, b, sgn, pool: int = KERNEL_POOL, gemm_dtype=torch.bfloat16,
                      sel_dtype=torch.bfloat16):
    """B4: ``(a_sel (B, T/pool, C) sel_dtype, Σa, Σa², #(a>0))``, stats ``(C,)`` f32."""
    if x.device.type == "cpu":
        return conv_block0_train_reference(x, w, b, sgn, pool, gemm_dtype, sel_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block0_train: no kernel for device {x.device}")
    x2 = _check("conv_block0_train", x, w, pool, gemm_dtype, b, sgn)
    if sel_dtype not in _DTYPES:
        raise ValueError("conv_block0_train: sel_dtype must be float32 or bfloat16")
    B, T = x2.shape
    c = w.shape[2]
    f32 = gemm_dtype == torch.float32
    sel_bf16 = int(sel_dtype == torch.bfloat16)
    tile, n_cps, n_ctas = _tc_grid("conv_block0_train", x2, c, "fwd_f32" if f32 else "fwd",
                                   2 if sel_bf16 else 4)
    sel = torch.empty((B, T // pool, c), dtype=sel_dtype, device=x.device)
    part = torch.empty((n_ctas, 3, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((3, c), dtype=torch.float32, device=x.device)
    from .._build import check, library

    bias, sg = b.float().contiguous(), sgn.float().contiguous()
    wf = w.float()  # read in place, by its strides; the kernel packs it
    with torch.cuda.device(x.device):
        err = library().vm_block0_train_tc_fwd(
            x2.data_ptr(), wf.data_ptr(), wf.stride(0), wf.stride(2), bias.data_ptr(),
            sg.data_ptr(), sel.data_ptr(), part.data_ptr(), stats.data_ptr(), B, T, c, tile,
            n_cps, sel_bf16, int(f32), torch.cuda.current_stream().cuda_stream)
    check(err, "conv_block0_train (" + ("float32 GEMM" if f32 else "bfloat16 GEMM") + ")")
    if f32:
        conv_block0_train.f32_launches += 1
    else:
        conv_block0_train.launches += 1
    return sel, stats[0], stats[1], stats[2]


def _bwd_launch(name, x, w, b, sgn, g, c0, c1, c2, pool, gemm_dtype, stage: bool):
    x2 = _check(name, x, w, pool, gemm_dtype, b, sgn, g, c0, c1, c2)
    B, T = x2.shape
    c = w.shape[2]
    if g.shape != (B, T // pool, c):
        raise ValueError(f"{name}: g must be {(B, T // pool, c)}, got {tuple(g.shape)}")
    f32 = gemm_dtype == torch.float32
    gf = g.float().contiguous()  # the kernels read g in f32 and round it themselves
    if gf.data_ptr() % 16:  # an offset view: the kernels read pairs of floats
        gf = gf.clone()
    tile, n_cps, n_ctas = _tc_grid(name, x2, c, "bwd_f32" if f32 else "bwd")
    part = torch.empty((n_ctas, KERNEL_TAPS + 1, c), dtype=torch.float32, device=x.device)
    out = torch.empty((KERNEL_TAPS + 1, c), dtype=torch.float32, device=x.device)
    staged = ()
    if stage:
        staged = (torch.empty((B, T // pool, c), dtype=torch.float32, device=x.device),
                  torch.empty((B, T // pool, c), dtype=torch.uint8, device=x.device))
    sel_ptr, route_ptr = (t.data_ptr() for t in staged) if stage else (None, None)
    from .._build import check, library

    bias, sg = b.float().contiguous(), sgn.float().contiguous()
    cs = [v.float().contiguous() for v in (c0, c1, c2)]
    wf = w.float()  # read in place, by its strides; the kernel packs it
    with torch.cuda.device(x.device):
        err = library().vm_block0_train_tc_bwd(
            x2.data_ptr(), wf.data_ptr(), wf.stride(0), wf.stride(2), bias.data_ptr(),
            sg.data_ptr(), *(v.data_ptr() for v in cs), gf.data_ptr(), part.data_ptr(),
            out.data_ptr(), sel_ptr, route_ptr, B, T, c, tile, n_cps, int(f32),
            torch.cuda.current_stream().cuda_stream)
    check(err, f"{name} (" + ("float32 GEMM" if f32 else "bfloat16 GEMM") + ")")
    return (out[:KERNEL_TAPS, None, :], out[KERNEL_TAPS], *staged), f32


def conv_block0_train_bwd(x, w, b, sgn, g, c0, c1, c2, pool: int = KERNEL_POOL,
                          gemm_dtype=torch.bfloat16):
    """B5: ``(dw (k, 1, C) f32, db (C,) f32)`` for the pooled cotangent ``g``."""
    if x.device.type == "cpu":
        return conv_block0_train_bwd_reference(x, w, b, sgn, g, c0, c1, c2, pool, gemm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block0_train_bwd: no kernel for device {x.device}")
    out, f32 = _bwd_launch("conv_block0_train_bwd", x, w, b, sgn, g, c0, c1, c2, pool,
                           gemm_dtype, stage=False)
    if f32:
        conv_block0_train_bwd.f32_launches += 1
    else:
        conv_block0_train_bwd.launches += 1
    return out


def relu_bits(a: torch.Tensor, pool: int = KERNEL_POOL) -> torch.Tensor:
    """``a (B, C, T)`` → ``(B, T/pool, C)`` uint8, bit j set where phase j's
    ``a_j > 0``, as the stage entry reports it."""
    B, c, T = a.shape
    weights = (2 ** torch.arange(pool, device=a.device))[None, None, None, :]
    bits = ((a.view(B, c, T // pool, pool) > 0).long() * weights).sum(-1)
    return bits.to(torch.uint8).transpose(1, 2).contiguous()


def conv_block0_train_bwd_stage_reference(x, w, b, sgn, g, c0, c1, c2, pool: int = KERNEL_POOL,
                                          gemm_dtype=torch.bfloat16):
    """Plain version of the stage entry: B5's ``(dw, db)`` and what it
    recomputes, ``s·max_j(s·a_j)`` ``(B, T/pool, C)`` f32, the phase the
    cotangent is routed to and the relu mask of each phase (``relu_bits``),
    uint8."""
    dw, db = conv_block0_train_bwd_reference(x, w, b, sgn, g, c0, c1, c2, pool, gemm_dtype)
    a, _ = _activation(x, w, b, gemm_dtype)
    B, c, T = a.shape
    sa = a.view(B, c, T // pool, pool) * sgn.float()[None, :, None, None]
    best = sa.amax(-1)
    eq = sa == best[..., None]
    route = (eq & (eq.cumsum(-1) == 1)).float().argmax(-1)
    sel = (best * sgn.float()[None, :, None]).transpose(1, 2).contiguous()
    return (dw, db, sel, route.to(torch.uint8).transpose(1, 2).contiguous(),
            relu_bits(a, pool))


def conv_block0_train_bwd_routed_reference(x, w, b, sgn, g, c0, c1, c2, route, relu,
                                           pool: int = KERNEL_POOL, gemm_dtype=torch.bfloat16):
    """The plain ``(dw, db)`` of B5 on given routes and relu masks: the plain
    activation, but the cotangent routed to ``route (B, T/pool, C)`` and dz
    kept where ``relu (B, T/pool, C)``'s bit j says a_j > 0 (as the stage
    entry reports them), so that what remains against the kernel is its sum
    order and not its routing or relu flips."""
    dz, xp = bwd_dz(x, w, b, sgn, g, c0, c1, c2, pool, gemm_dtype, route, relu)
    return _dw_db(dz, xp, w.shape[0], gemm_dtype)


def conv_block0_train_bwd_stage(x, w, b, sgn, g, c0, c1, c2, pool: int = KERNEL_POOL,
                                gemm_dtype=torch.bfloat16):
    """B5's kernel (of ``gemm_dtype``'s route), also writing what it
    recomputed: ``(dw, db, sel (B, T/pool, C) f32, route (B, T/pool, C)
    uint8, relu (B, T/pool, C) uint8)``, relu bit j set where phase j's
    a_j > 0. On no path; ``chip_smoke.py`` holds ``sel`` to B4's f32
    ``a_sel`` on the same route bit for bit and feeds ``route`` and ``relu``
    to the plain dW."""
    if x.device.type == "cpu":
        return conv_block0_train_bwd_stage_reference(x, w, b, sgn, g, c0, c1, c2, pool,
                                                     gemm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block0_train_bwd_stage: no kernel for device {x.device}")
    (dw, db, sel, byte), _ = _bwd_launch("conv_block0_train_bwd_stage", x, w, b, sgn, g, c0,
                                         c1, c2, pool, gemm_dtype, stage=True)
    conv_block0_train_bwd_stage.launches += 1
    return dw, db, sel, byte & 3, byte >> 2


# kernel launches; the CPU path does not count: a bf16 GEMM's kernels and
# an f32 GEMM's
conv_block0_train.launches = 0
conv_block0_train.f32_launches = 0
conv_block0_train_bwd.launches = 0
conv_block0_train_bwd.f32_launches = 0
conv_block0_train_bwd_stage.launches = 0
