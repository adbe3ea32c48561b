"""B7: the max-pool and BatchNorm passes of the blocks-1+ train op.

Port of ``voicemap_tpu/ops/pallas_routing.py :: pallas_pool_fwd`` and
``pallas_route_bwd``. Both kernels live in ``csrc/routing.cu``;
``pool_fwd_reference`` and ``route_bwd_reference`` are their plain PyTorch
versions.

The layout is channel-first, ``(B, C, T)``, the layout the port's cuDNN
convs write and read (the JAX package's ``(B, T, C)`` lane view was the
TPU's): ``a`` is the full-rate relu activation, ``a_sel``, ``g`` and the
selection are ``(B, C, T/pool)``. Any B, any C, T % pool == 0.

- ``pool_fwd``: ``a_sel = s · max_j(s · a_j)`` over each pool window,
  ``s = sgn`` (±1, the sign of the BatchNorm scale), plus Σa and Σa² per
  channel in f32;
- ``route_bwd``: ``g`` cast to ``a``'s dtype (as the TPU wrapper casts it),
  routed to the first phase whose value equals ``a_sel`` (so ``a_sel`` must
  be in ``a``'s dtype: value ties are then exactly selection ties), then
  ``dz = 1[a>0]·((c0·g + c1) + c2·a)`` op by op in f32, written in
  ``out_dtype``, and ``db = Σ dz`` in f32.

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import torch

_DTYPES = (torch.float32, torch.bfloat16)


def pool_fwd_reference(a, sgn, pool: int, sel_dtype=torch.bfloat16):
    """Plain PyTorch version → ``(a_sel (B, C, T/pool), Σa (C,), Σa² (C,))``."""
    B, c, T = a.shape
    af = a.float()
    s = sgn.float()
    best = (af.view(B, c, T // pool, pool) * s[None, :, None, None]).amax(-1)
    return (best * s[None, :, None]).to(sel_dtype), af.sum((0, 2)), (af * af).sum((0, 2))


def route_bwd_reference(a, a_sel, g, c0, c1, c2, pool: int, out_dtype=torch.bfloat16):
    """Plain PyTorch version → ``(dz (B, C, T) out_dtype, db (C,) f32)``."""
    B, c, T = a.shape
    ar = a.float().view(B, c, T // pool, pool)
    eq = ar == a_sel.float()[..., None]
    first = eq & (eq.cumsum(-1) == 1)
    gj = torch.where(first, g.to(a.dtype).float()[..., None], 0.0)
    col = lambda v: v.float()[None, :, None, None]  # noqa: E731
    dz = col(c0) * gj + col(c1) + col(c2) * ar
    dz = torch.where(ar > 0, dz, 0.0).view(B, c, T)
    return dz.to(out_dtype), dz.sum((0, 2))


def _check(name, a, pool, *others):
    if a.dim() != 3 or a.dtype not in _DTYPES:
        raise ValueError(f"{name}: a must be a (B, C, T) float32 or bfloat16 tensor")
    B, c, T = a.shape
    if pool < 1 or T < pool or T % pool:
        raise ValueError(f"{name}: T={T} must be a positive multiple of pool={pool}")
    if not 1 <= B <= 65535:
        raise ValueError(f"{name}: 1 to 65535 rows a launch, got {B}")
    if any(t.device != a.device for t in others):
        raise ValueError(f"{name}: every tensor must lie on {a.device}")
    return a.contiguous()


def pool_fwd(a, sgn, pool: int, sel_dtype=torch.bfloat16):
    """B7 forward: ``(a_sel (B, C, T/pool) sel_dtype, Σa (C,), Σa² (C,))``, one read of ``a``."""
    if a.device.type == "cpu":
        return pool_fwd_reference(a, sgn, pool, sel_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"pool_fwd: no kernel for device {a.device}")
    a = _check("pool_fwd", a, pool, sgn)
    if sel_dtype not in _DTYPES:
        raise ValueError("pool_fwd: sel_dtype must be float32 or bfloat16")
    B, c, T = a.shape
    sel = torch.empty((B, c, T // pool), dtype=sel_dtype, device=a.device)
    part = torch.empty((B, 2, c), dtype=torch.float32, device=a.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=a.device)
    sg = sgn.float().contiguous()
    from .._build import check, library

    with torch.cuda.device(a.device):
        err = library().vm_pool_fwd(
            a.data_ptr(), sg.data_ptr(), sel.data_ptr(), part.data_ptr(), stats.data_ptr(),
            B, c, T, pool, int(a.dtype == torch.bfloat16), int(sel_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check(err, "pool_fwd")
    pool_fwd.launches += 1
    return sel, stats[0], stats[1]


def route_bwd(a, a_sel, g, c0, c1, c2, pool: int, out_dtype=torch.bfloat16):
    """B7 backward: ``(dz (B, C, T) out_dtype, db (C,) f32)``, one read of ``a``."""
    if a.device.type == "cpu":
        return route_bwd_reference(a, a_sel, g, c0, c1, c2, pool, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"route_bwd: no kernel for device {a.device}")
    a = _check("route_bwd", a, pool, a_sel, g, c0, c1, c2)
    B, c, T = a.shape
    if a_sel.dtype != a.dtype:
        raise ValueError(f"route_bwd: a_sel must be in a's dtype {a.dtype} for exact-match "
                         f"routing, got {a_sel.dtype}")
    if a_sel.shape != (B, c, T // pool) or g.shape != a_sel.shape:
        raise ValueError(f"route_bwd: a_sel and g must be {(B, c, T // pool)}")
    if out_dtype not in _DTYPES:
        raise ValueError("route_bwd: out_dtype must be float32 or bfloat16")
    sel = a_sel.contiguous()
    gq = g.to(a.dtype).contiguous()
    cc = torch.stack([c0.float(), c1.float(), c2.float()]).contiguous()
    dz = torch.empty((B, c, T), dtype=out_dtype, device=a.device)
    part = torch.empty((B, c), dtype=torch.float32, device=a.device)
    db = torch.empty((c,), dtype=torch.float32, device=a.device)
    from .._build import check, library

    with torch.cuda.device(a.device):
        err = library().vm_route_bwd(
            a.data_ptr(), sel.data_ptr(), gq.data_ptr(), cc.data_ptr(), dz.data_ptr(),
            part.data_ptr(), db.data_ptr(), B, c, T, pool, int(a.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    check(err, "route_bwd")
    route_bwd.launches += 1
    return dz, db


pool_fwd.launches = 0  # kernel launches; the CPU path does not count
route_bwd.launches = 0
