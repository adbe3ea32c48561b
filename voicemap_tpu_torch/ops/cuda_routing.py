"""B7: the max-pool and BatchNorm passes of the blocks-1+ train op.

Port of ``voicemap_tpu/ops/pallas_routing.py :: pallas_pool_fwd`` and
``pallas_route_bwd``, with the conv's bias and relu folded in. Both kernels
live in ``csrc/routing.cu``; ``pool_fwd_reference`` and
``route_bwd_reference`` are their plain PyTorch versions.

The layout is channels last, as the JAX package lays it out: every
full-rate and pool-rate tensor has the logical shape ``(B, C, T)`` and the
memory of a ``(B, T, C)`` tensor, strides ``(T·C, 1, C)`` (the layout
cuDNN's NHWC convs write; :func:`channels_last` makes one). ``z`` is the
conv's output without its bias, in the activation dtype;
``a = relu(z + b.to(z.dtype))``, the bits of the JAX package's
``jax.nn.relu(conv + b.astype(dtype))``. Any B, any C, T % pool == 0.

- ``pool_fwd``: ``a_sel = s · max_j(s · a_j)`` over each pool window,
  ``s = sgn`` (±1, the sign of the BatchNorm scale), plus Σa and Σa² per
  channel in f32. ``a`` is never written;
- ``route_bwd``: ``a`` recomputed from ``z`` and ``b``, ``g`` (f32) rounded
  to ``a``'s dtype (as the TPU wrapper casts it), routed to the first phase
  whose value equals ``a_sel`` (so ``a_sel`` must be in ``a``'s dtype: value
  ties are then exactly selection ties), then
  ``dz = 1[a>0]·((c0·g + c1) + c2·a)`` op by op in f32, written in
  ``out_dtype``, and ``db = Σ dz`` in f32.

The phase-index mode, for the pool-rate-residual variant of the op
(``make_fused_blockn_train(save_act=False)``, ``ops/conv_train.py``'s
``FusedBlocknRecompute``), whose backward recomputes ``a`` from another conv
than its forward's, so that routing by value could miss: ``pool_fwd(...,
want_idx=True)`` also returns ``idx`` (int8, channels last, pool rate), the
first phase whose ``s·a`` is the strict max (the JAX package's ``_pool_lane``
index, and the phase the value mode routes to), and ``route_bwd`` given
``idx`` (int8) in ``a_sel``'s place routes ``g`` to that phase. Each mode is
its own instance of the same kernels; they count apart, the index mode on
``idx_launches``.

The BatchNorm epilogue of the fused train blocks, at pool rate, over the
``(B, T', C)`` memory of ``a_sel`` (block 0's ``(B, T/4, C)`` tensor, or a
blocks-1+ ``a_sel`` viewed through ``permute(0, 2, 1)``), the same pair of
kernels for both:

- ``bn_apply``: ``y = round(((a_sel − μ)·scale) + β)`` in the output dtype
  (the compute dtype: f32, bf16 or f16), each operation rounded in f32,
  then with a spatial-dropout keep mask ``m (B, C)``
  ``y = m ? round(y / keep) : 0``: the bits of
  ``spatial_dropout(pooled.to(dtype))``;
- ``bn_grad``: the cotangent ``g`` of ``y`` → ``g' = m ? round(g / keep) : 0``
  in f32 (the f32 cotangent B7 and B5 read) and, per channel, ``Σg'`` and
  ``Σg'·â`` with ``â = (a_sel − μ)·r``, folded in a fixed order.

``bn_apply_reference`` and ``bn_grad_reference`` are the PyTorch ops they
replace, in their order. A division by ``keep`` is the one PyTorch makes on
the tensor's device: on the card a product with the f32 reciprocal of
``keep`` (how CUDA divides by a host scalar), on the CPU a true division.

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises. All
raise on a tensor in another layout: they never copy one into theirs.
"""

from __future__ import annotations

import functools

import torch

_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256  # csrc/routing.cu kThreads: a CTA's threads, one vector of channels each
UNROLL = 2  # csrc/routing.cu kUnroll: positions a thread loads before it uses them
MAX_POOL = 8  # csrc/routing.cu kMaxPool
# csrc/routing.cu kFwdCtasPerSm, kBwdCtasPerSm: the CTAs of each pass an SM
# holds at once (its registers are capped for it), which the strips fill once.
FWD_CTAS_PER_SM = 3
BWD_CTAS_PER_SM = 2
# csrc/routing.cu kApplyCtasPerSm, kGradCtasPerSm: the same for bn_apply and bn_grad
APPLY_CTAS_PER_SM = 4
GRAD_CTAS_PER_SM = 3


def channels_last(shape, dtype, device) -> torch.Tensor:
    """An empty ``(B, C, T)`` tensor laid out as ``(B, T, C)``."""
    B, c, T = shape
    return torch.empty((B, T, c), dtype=dtype, device=device).permute(0, 2, 1)


def is_channels_last(t: torch.Tensor) -> bool:
    """``t`` (B, C, T) has the dense memory of a (B, T, C) tensor."""
    return t.dim() == 3 and t.permute(0, 2, 1).is_contiguous()


def vector_width(c: int, dtype: torch.dtype, *tensors) -> int:
    """Channels a thread moves as one access: 16 bytes of ``dtype`` where C
    divides by it and every tensor starts on 16 bytes, else 1."""
    widest = 16 // dtype.itemsize
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return widest if c % widest == 0 and aligned else 1


def launch_plan(B: int, c: int, T: int, pool: int, vec: int, slots: int) -> tuple[int, int]:
    """``(strips, span)``: each batch row's T/pool positions cut into
    ``strips`` strips of ``span`` positions, one CTA each (per 256 vectors of
    channels), as many as fill the card's ``slots`` (SMs × CTAs an SM) once
    and no more: each CTA's partial row costs a fold, and a second wave of a
    few CTAs costs a whole CTA's time. Every thread keeps at least two
    batches of UNROLL positions."""
    tp = T // pool
    cols = c // vec
    chunks = -(-cols // THREADS)
    rows = THREADS // min(cols, THREADS)
    strips = max(1, min(slots // (B * chunks), tp // (rows * UNROLL * 2)))
    span = -(-tp // strips)
    return -(-tp // span), span


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _activation(z, b):
    return torch.relu(z + b.to(z.dtype)[:, None])


def _btc(t, pool=1):
    """The (B, T, C) memory of a channels-last (B, C, T) tensor, viewed as
    (B, T/pool, pool, C)."""
    B, c, T = t.shape
    return t.permute(0, 2, 1).reshape(B, T // pool, pool, c)


def first_max_phase(v: torch.Tensor) -> torch.Tensor:
    """``v (B, T/pool, pool, C)`` → int8 ``(B, T/pool, C)``: the first phase
    ``j`` with ``v_j`` greater than every earlier phase's, from −inf (the
    kernel's rule: a NaN is never taken)."""
    best = torch.full_like(v[:, :, 0], float("-inf"))
    idx = torch.zeros(best.shape, dtype=torch.int8, device=v.device)
    for j in range(v.shape[2]):
        gt = v[:, :, j] > best
        idx = torch.where(gt, torch.tensor(j, dtype=torch.int8, device=v.device), idx)
        best = torch.fmax(best, v[:, :, j])
    return idx


def pool_fwd_reference(z, b, sgn, pool: int, sel_dtype=torch.bfloat16, want_idx: bool = False):
    """Plain PyTorch version → ``(a_sel (B, C, T/pool), Σa (C,), Σa² (C,))``,
    and with ``want_idx`` the phase index ``idx (B, C, T/pool)`` int8 after
    them."""
    B, c, T = z.shape
    af = _btc(_activation(z, b), pool).float()
    s = sgn.float()
    best = (af * s).amax(2)
    sel = (best * s).to(sel_dtype).permute(0, 2, 1)
    out = (sel, af.sum((0, 1, 2)), (af * af).sum((0, 1, 2)))
    if want_idx:
        out += (first_max_phase(af * s).permute(0, 2, 1),)
    return out


def route_bwd_reference(z, b, a_sel, g, c0, c1, c2, pool: int, out_dtype=torch.bfloat16):
    """Plain PyTorch version → ``(dz (B, C, T) out_dtype, db (C,) f32)``;
    ``a_sel`` int8 is the phase index."""
    B, c, T = z.shape
    a = _activation(z, b)
    ar = _btc(a, pool).float()
    if a_sel.dtype == torch.int8:
        first = torch.arange(pool, device=z.device).view(1, 1, pool, 1) == _btc(a_sel).long()
    else:
        eq = ar == _btc(a_sel).float()
        first = eq & (eq.cumsum(2) == 1)
    gj = torch.where(first, _btc(g.to(a.dtype)).float(), 0.0)
    dz = c0.float() * gj + c1.float() + c2.float() * ar
    dz = torch.where(ar > 0, dz, 0.0)
    return dz.to(out_dtype).reshape(B, T, c).permute(0, 2, 1), dz.sum((0, 1, 2))


def _check(name, z, b, pool, *others):
    if z.dim() != 3 or z.dtype not in _DTYPES:
        raise ValueError(f"{name}: z must be a (B, C, T) float32 or bfloat16 tensor")
    B, c, T = z.shape
    if not 1 <= pool <= MAX_POOL or T < pool or T % pool:
        raise ValueError(f"{name}: T={T} must be a positive multiple of pool={pool} "
                         f"(1 to {MAX_POOL})")
    if b.shape != (c,):
        raise ValueError(f"{name}: b must be ({c},)")
    if any(t.device != z.device for t in (b, *others)):
        raise ValueError(f"{name}: every tensor must lie on {z.device}")
    for t in (z, *(o for o in others if o.dim() == 3)):
        if not is_channels_last(t):
            raise ValueError(f"{name}: tensors must be channels last, (B, C, T) with strides "
                             f"(T·C, 1, C); got strides {tuple(t.stride())}")


def pool_fwd(z, b, sgn, pool: int, sel_dtype=torch.bfloat16, want_idx: bool = False):
    """B7 forward: ``(a_sel (B, C, T/pool) sel_dtype, Σa (C,), Σa² (C,))``,
    one read of ``z``; with ``want_idx`` also ``idx (B, C, T/pool)`` int8,
    the selected phase."""
    _check("pool_fwd", z, b, pool, sgn)
    if z.device.type == "cpu":
        return pool_fwd_reference(z, b, sgn, pool, sel_dtype, want_idx)
    if z.device.type != "cuda":
        raise ValueError(f"pool_fwd: no kernel for device {z.device}")
    if sel_dtype not in _DTYPES:
        raise ValueError("pool_fwd: sel_dtype must be float32 or bfloat16")
    B, c, T = z.shape
    sel = channels_last((B, c, T // pool), sel_dtype, z.device)
    idx = channels_last((B, c, T // pool), torch.int8, z.device) if want_idx else None
    vec = vector_width(c, z.dtype, z, sel, *(() if idx is None else (idx,)))
    strips, span = launch_plan(B, c, T, pool, vec, _sms(z.device.index) * FWD_CTAS_PER_SM)
    part = torch.empty((B * strips, 2, c), dtype=torch.float32, device=z.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=z.device)
    bf, sg = b.float().contiguous(), sgn.float().contiguous()
    from .._build import check, library

    with torch.cuda.device(z.device):
        err = library().vm_pool_fwd(
            z.data_ptr(), bf.data_ptr(), sg.data_ptr(), sel.data_ptr(),
            None if idx is None else idx.data_ptr(), part.data_ptr(), stats.data_ptr(), B, c, T,
            pool, vec, strips, span, int(z.dtype == torch.bfloat16),
            int(sel_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    check(err, "pool_fwd")
    if idx is None:
        pool_fwd.launches += 1
        return sel, stats[0], stats[1]
    pool_fwd.idx_launches += 1
    return sel, stats[0], stats[1], idx


def route_bwd(z, b, a_sel, g, c0, c1, c2, pool: int, out_dtype=torch.bfloat16):
    """B7 backward: ``(dz (B, C, T) out_dtype, db (C,) f32)``, one read of
    ``z``; ``a_sel`` int8 is ``pool_fwd``'s ``idx``, and routes by phase."""
    _check("route_bwd", z, b, pool, a_sel, g, c0, c1, c2)
    B, c, T = z.shape
    by_idx = a_sel.dtype == torch.int8
    if not by_idx and a_sel.dtype != z.dtype:
        raise ValueError(f"route_bwd: a_sel must be in z's dtype {z.dtype} for exact-match "
                         f"routing, or the int8 phase index; got {a_sel.dtype}")
    if a_sel.shape != (B, c, T // pool) or g.shape != a_sel.shape:
        raise ValueError(f"route_bwd: a_sel and g must be {(B, c, T // pool)}")
    if g.dtype != torch.float32:
        raise ValueError(f"route_bwd: g must be float32 (rounded to z's dtype inside), "
                         f"got {g.dtype}")
    if z.device.type == "cpu":
        return route_bwd_reference(z, b, a_sel, g, c0, c1, c2, pool, out_dtype)
    if z.device.type != "cuda":
        raise ValueError(f"route_bwd: no kernel for device {z.device}")
    if out_dtype not in _DTYPES:
        raise ValueError("route_bwd: out_dtype must be float32 or bfloat16")
    cs = [v.float().contiguous() for v in (c0, c1, c2)]
    dz = channels_last((B, c, T), out_dtype, z.device)
    vec = vector_width(c, z.dtype, z, a_sel, g, dz)
    strips, span = launch_plan(B, c, T, pool, vec, _sms(z.device.index) * BWD_CTAS_PER_SM)
    part = torch.empty((B * strips, c), dtype=torch.float32, device=z.device)
    db = torch.empty((c,), dtype=torch.float32, device=z.device)
    bf = b.float().contiguous()
    from .._build import check, library

    with torch.cuda.device(z.device):
        err = library().vm_route_bwd(
            z.data_ptr(), bf.data_ptr(), a_sel.data_ptr(), g.data_ptr(), *(v.data_ptr() for v in cs),
            dz.data_ptr(), part.data_ptr(), db.data_ptr(), B, c, T, pool, vec, strips, span,
            int(z.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), int(by_idx),
            torch.cuda.current_stream().cuda_stream)
    check(err, "route_bwd")
    if by_idx:
        route_bwd.idx_launches += 1
    else:
        route_bwd.launches += 1
    return dz, db


@functools.lru_cache(maxsize=None)
def _inv_keep(keep: float) -> float:
    """``1 / keep`` as CUDA's division by a host scalar forms it: both in f32."""
    return float(torch.tensor(1.0) / torch.tensor(keep, dtype=torch.float32))


def bn_apply_reference(sel, mu, scale, beta, mask, keep: float, out_dtype):
    """Plain PyTorch version → ``y (B, T', C) out_dtype``."""
    y = ((sel.float() - mu) * scale + beta).to(out_dtype)
    if mask is None:
        return y
    return torch.where(mask.bool()[:, None, :], y / keep, 0.0).to(out_dtype)


def bn_grad_reference(g, sel, mask, keep: float, mu, r):
    """Plain PyTorch version → ``(g' (B, T', C) f32, Σg' (C,), Σg'·â (C,))``."""
    if mask is not None:
        g = torch.where(mask.bool()[:, None, :], g, 0.0) / keep
    gf = g.float()
    ahat = (sel.float() - mu) * r
    return gf, gf.sum((0, 1)), (gf * ahat).sum((0, 1))


def _check_bn(name, t, mask, *vectors):
    if t.dim() != 3 or not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous (B, T', C), got shape "
                         f"{tuple(t.shape)}, strides {tuple(t.stride())}")
    B, _, c = t.shape
    if any(v.shape != (c,) for v in vectors):
        raise ValueError(f"{name}: the channel vectors must be ({c},)")
    if mask is not None and (mask.shape != (B, c) or mask.dtype != torch.float32
                             or not mask.is_contiguous()):
        raise ValueError(f"{name}: the mask must be a contiguous ({B}, {c}) float32 tensor")
    if any(v.device != t.device for v in (*vectors, *(() if mask is None else (mask,)))):
        raise ValueError(f"{name}: every tensor must lie on {t.device}")


def _narrower(*dtypes) -> torch.dtype:
    return min(dtypes, key=lambda d: d.itemsize)


# The epilogue's dtype codes (csrc/routing.cu with_elem): y and its
# cotangent take any of the three, a_sel (the GEMM's dtype) the first two.
_EPILOGUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def bn_apply(sel, mu, scale, beta, mask, keep: float, out_dtype):
    """The epilogue's forward: ``y (B, T', C) out_dtype`` (f32, bf16 or f16)
    from ``sel (B, T', C)`` (f32 or bf16), per-channel ``mu``, ``scale`` and
    ``beta``, and a keep ``mask (B, C)`` f32 with its ``keep``, or None at
    no dropout; one read of ``sel``."""
    _check_bn("bn_apply", sel, mask, mu, scale, beta)
    if sel.device.type == "cpu":
        return bn_apply_reference(sel, mu, scale, beta, mask, keep, out_dtype)
    if sel.device.type != "cuda":
        raise ValueError(f"bn_apply: no kernel for device {sel.device}")
    if sel.dtype not in _DTYPES or out_dtype not in _EPILOGUE_CODES:
        raise ValueError("bn_apply: sel must be float32 or bfloat16, out_dtype float32, "
                         "bfloat16 or float16")
    B, tp, c = sel.shape
    y = torch.empty((B, tp, c), dtype=out_dtype, device=sel.device)
    vec = vector_width(c, _narrower(sel.dtype, out_dtype), sel, y)
    strips, span = launch_plan(B, c, tp, 1, vec, _sms(sel.device.index) * APPLY_CTAS_PER_SM)
    m, sc, be = (v.float().contiguous() for v in (mu, scale, beta))
    from .._build import check, library

    with torch.cuda.device(sel.device):
        err = library().vm_bn_apply(
            sel.data_ptr(), m.data_ptr(), sc.data_ptr(), be.data_ptr(),
            None if mask is None else mask.data_ptr(), _inv_keep(keep), y.data_ptr(), B, c, tp,
            vec, strips, span, _EPILOGUE_CODES[sel.dtype], _EPILOGUE_CODES[out_dtype],
            torch.cuda.current_stream().cuda_stream)
    check(err, "bn_apply")
    bn_apply.launches += 1
    return y


def bn_grad(g, sel, mask, keep: float, mu, r):
    """The epilogue's backward: ``(g' (B, T', C) f32, Σg' (C,), Σg'·â (C,))``
    for the cotangent ``g`` of ``bn_apply``'s ``y``, in ``y``'s dtype; one
    read of ``g`` and of ``sel``; ``mask`` and ``keep`` as ``bn_apply``
    took them."""
    _check_bn("bn_grad", sel, mask, mu, r)
    if g.shape != sel.shape or not g.is_contiguous() or g.device != sel.device:
        raise ValueError(f"bn_grad: g must be a contiguous {tuple(sel.shape)} tensor on "
                         f"{sel.device}")
    if sel.device.type == "cpu":
        return bn_grad_reference(g, sel, mask, keep, mu, r)
    if sel.device.type != "cuda":
        raise ValueError(f"bn_grad: no kernel for device {sel.device}")
    if sel.dtype not in _DTYPES or g.dtype not in _EPILOGUE_CODES:
        raise ValueError("bn_grad: sel must be float32 or bfloat16, g float32, bfloat16 or "
                         "float16")
    B, tp, c = sel.shape
    gout = torch.empty((B, tp, c), dtype=torch.float32, device=sel.device)
    vec = vector_width(c, _narrower(sel.dtype, g.dtype), sel, g, gout)
    strips, span = launch_plan(B, c, tp, 1, vec, _sms(sel.device.index) * GRAD_CTAS_PER_SM)
    part = torch.empty((B * strips, 2, c), dtype=torch.float32, device=sel.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=sel.device)
    m, rr = mu.float().contiguous(), r.float().contiguous()
    from .._build import check, library

    with torch.cuda.device(sel.device):
        err = library().vm_bn_grad(
            g.data_ptr(), sel.data_ptr(), None if mask is None else mask.data_ptr(),
            _inv_keep(keep), m.data_ptr(), rr.data_ptr(), gout.data_ptr(), part.data_ptr(),
            sums.data_ptr(), B, c, tp, vec, strips, span, _EPILOGUE_CODES[g.dtype],
            _EPILOGUE_CODES[sel.dtype], torch.cuda.current_stream().cuda_stream)
    check(err, "bn_grad")
    bn_grad.launches += 1
    return gout, sums[0], sums[1]


# kernel launches; the CPU path does not count: the value mode, the index mode
pool_fwd.launches = 0
pool_fwd.idx_launches = 0
route_bwd.launches = 0
route_bwd.idx_launches = 0
bn_apply.launches = 0
bn_grad.launches = 0
