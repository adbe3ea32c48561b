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

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises. Both
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


def pool_fwd_reference(z, b, sgn, pool: int, sel_dtype=torch.bfloat16):
    """Plain PyTorch version → ``(a_sel (B, C, T/pool), Σa (C,), Σa² (C,))``."""
    B, c, T = z.shape
    af = _btc(_activation(z, b), pool).float()
    s = sgn.float()
    best = (af * s).amax(2)
    sel = (best * s).to(sel_dtype).permute(0, 2, 1)
    return sel, af.sum((0, 1, 2)), (af * af).sum((0, 1, 2))


def route_bwd_reference(z, b, a_sel, g, c0, c1, c2, pool: int, out_dtype=torch.bfloat16):
    """Plain PyTorch version → ``(dz (B, C, T) out_dtype, db (C,) f32)``."""
    B, c, T = z.shape
    a = _activation(z, b)
    ar = _btc(a, pool).float()
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


def pool_fwd(z, b, sgn, pool: int, sel_dtype=torch.bfloat16):
    """B7 forward: ``(a_sel (B, C, T/pool) sel_dtype, Σa (C,), Σa² (C,))``,
    one read of ``z``."""
    _check("pool_fwd", z, b, pool, sgn)
    if z.device.type == "cpu":
        return pool_fwd_reference(z, b, sgn, pool, sel_dtype)
    if z.device.type != "cuda":
        raise ValueError(f"pool_fwd: no kernel for device {z.device}")
    if sel_dtype not in _DTYPES:
        raise ValueError("pool_fwd: sel_dtype must be float32 or bfloat16")
    B, c, T = z.shape
    sel = channels_last((B, c, T // pool), sel_dtype, z.device)
    vec = vector_width(c, z.dtype, z, sel)
    strips, span = launch_plan(B, c, T, pool, vec, _sms(z.device.index) * FWD_CTAS_PER_SM)
    part = torch.empty((B * strips, 2, c), dtype=torch.float32, device=z.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=z.device)
    bf, sg = b.float().contiguous(), sgn.float().contiguous()
    from .._build import check, library

    with torch.cuda.device(z.device):
        err = library().vm_pool_fwd(
            z.data_ptr(), bf.data_ptr(), sg.data_ptr(), sel.data_ptr(), part.data_ptr(),
            stats.data_ptr(), B, c, T, pool, vec, strips, span, int(z.dtype == torch.bfloat16),
            int(sel_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    check(err, "pool_fwd")
    pool_fwd.launches += 1
    return sel, stats[0], stats[1]


def route_bwd(z, b, a_sel, g, c0, c1, c2, pool: int, out_dtype=torch.bfloat16):
    """B7 backward: ``(dz (B, C, T) out_dtype, db (C,) f32)``, one read of ``z``."""
    _check("route_bwd", z, b, pool, a_sel, g, c0, c1, c2)
    B, c, T = z.shape
    if a_sel.dtype != z.dtype:
        raise ValueError(f"route_bwd: a_sel must be in z's dtype {z.dtype} for exact-match "
                         f"routing, got {a_sel.dtype}")
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
            int(z.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check(err, "route_bwd")
    route_bwd.launches += 1
    return dz, db


pool_fwd.launches = 0  # kernel launches; the CPU path does not count
route_bwd.launches = 0
