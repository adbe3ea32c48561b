"""The collectives of the sequence, tensor and pipeline parallel programs.

A JAX program under ``shard_map`` names a mesh axis and calls ``ppermute``,
``all_gather``, ``psum`` and ``pmean`` over it; JAX differentiates them by
their transposes. Here an axis is an :class:`Axis` (its process group, its
size, this rank's index on it and its ranks), built by :func:`axis` from a
``DeviceMesh``, and the four collectives are ``torch.autograd.Function``\\ s
over plain ``send``/``recv`` (``batch_isend_irecv``), ``all_reduce`` and
``all_gather_into_tensor``, which gloo and NCCL both take:

| function | JAX | backward |
| --- | --- | --- |
| :func:`shift` | ``ppermute`` by a shift, zero-fill where no source | the reverse shift |
| :func:`all_gather` | ``all_gather`` (``tiled`` too) | the cotangents summed over the axis, own slice kept |
| :func:`psum` | ``psum`` | ``psum`` |
| :func:`pmean` | ``pmean`` | ``pmean`` |

Every backward is the adjoint of its forward over the whole axis: a rank's
gradient is that of the sum of every rank's loss, which is how JAX transposes
these under ``check_vma=False``. Two boundary functions stand for what
``shard_map`` does at its edge when a program is differentiated from outside:
:func:`replicated` (a replicated input: identity forward, the cotangents
summed over the axis backward, in one ``all_reduce``) and
:func:`replicated_out` (a replicated output: identity forward, the cotangent
divided by the axis size backward, as ``shard_map``'s transpose divides the
cotangent of an unmapped output). The torch ``all_gather`` of
``torch.distributed.nn`` is not used: its backward falls back to
``all_to_all`` off NCCL, and gloo has no ``reduce_scatter``; the gather's
backward here is an ``all_reduce`` and a slice.

Transport. Under NCCL a device tensor goes to the collective as it is. Under
a gloo group a CUDA tensor is copied to the host for the call and back
(gloo's send and recv take host tensors only): explicit, keyed on the group's
backend, and counted in :data:`STAGED` (bytes both ways, calls, seconds of
the staged calls). On the CPU nothing is staged. ``all_reduce_``,
``all_gather_into_tensor`` and ``exchange`` are these transports, used by
the rest of the parallel layer too.

The pytree helpers (:func:`tree_flatten`, :func:`tree_unflatten`) order a
dict's leaves by sorted key, as ``jax.tree_util`` (and ``ravel_pytree``)
orders them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

STAGED = {"bytes": 0, "calls": 0, "seconds": 0.0}


def reset_staged() -> None:
    STAGED.update(bytes=0, calls=0, seconds=0.0)


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it."""

    group: dist.ProcessGroup
    size: int
    index: int
    ranks: Tuple[int, ...]  # global ranks along the axis, in axis order

    def peer(self, index: int) -> int:
        """The global rank at ``index`` on the axis."""
        return self.ranks[index]


def axis(mesh: DeviceMesh, name: str) -> Axis:
    """The :class:`Axis` of ``name`` on ``mesh`` for this rank (which must be
    on the mesh)."""
    group = mesh.get_group(name)
    ranks = tuple(dist.get_process_group_ranks(group))
    return Axis(group, len(ranks), ranks.index(dist.get_rank()), ranks)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def _stages(group, tensors) -> bool:
    """Whether a call on ``group`` copies ``tensors`` through the host: a
    gloo group and a CUDA tensor."""
    return (str(dist.get_backend(group)) == "gloo"
            and any(t.is_cuda for t in tensors))


class _Staging:
    """Host copies of CUDA tensors for one gloo call, counted in STAGED."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def out(self, t: torch.Tensor) -> torch.Tensor:
        STAGED["bytes"] += t.numel() * t.element_size()
        return t.detach().cpu()

    def back(self, dst: torch.Tensor, host: torch.Tensor) -> None:
        STAGED["bytes"] += host.numel() * host.element_size()
        dst.copy_(host)

    def done(self) -> None:
        STAGED["calls"] += 1
        STAGED["seconds"] += time.perf_counter() - self.t0


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` in place over ``group``, staged through the host
    for a CUDA tensor under gloo; returns ``t``."""
    if not _stages(group, (t,)):
        dist.all_reduce(t, op=op, group=group)
        return t
    stage = _Staging()
    host = stage.out(t)
    dist.all_reduce(host, op=op, group=group)
    stage.back(t, host)
    stage.done()
    return t


def all_gather_into_tensor(out: torch.Tensor, t: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_gather_into_tensor`` (blocks in axis order along dim 0),
    staged for CUDA tensors under gloo; returns ``out``."""
    if not _stages(group, (t,)):
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out
    stage = _Staging()
    host_out = torch.empty(out.shape, dtype=out.dtype)
    dist.all_gather_into_tensor(host_out, stage.out(t.contiguous()), group=group)
    stage.back(out, host_out)
    stage.done()
    return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group, wait: bool = True):
    """Point-to-point: each ``(tensor, global rank)`` of ``sends`` sent,
    each of ``recvs`` received into, in one ``batch_isend_irecv``. Staged
    for CUDA tensors under gloo. ``wait=False`` returns a function that
    waits for the transfers and fills ``recvs`` (work may run meanwhile)."""
    finish = _exchange(sends, recvs, group)
    if not wait:
        return finish
    finish()
    return None


def _exchange(sends, recvs, group):
    if not sends and not recvs:
        return lambda: None
    tensors = [t for t, _ in sends] + [t for t, _ in recvs]
    stage = _Staging() if _stages(group, tensors) else None
    if stage is not None:
        send_bufs = [(stage.out(t), p) for t, p in sends]
        recv_bufs = [(torch.empty(t.shape, dtype=t.dtype), p) for t, p in recvs]
    else:
        send_bufs = [(t.contiguous(), p) for t, p in sends]
        recv_bufs = [(t if t.is_contiguous() else torch.empty_like(t), p) for t, p in recvs]
    ops = ([dist.P2POp(dist.isend, t, p, group) for t, p in send_bufs]
           + [dist.P2POp(dist.irecv, t, p, group) for t, p in recv_bufs])
    reqs = dist.batch_isend_irecv(ops)

    def finish() -> None:
        for req in reqs:
            req.wait()
        for (dst, _), (buf, _) in zip(recvs, recv_bufs):
            if stage is not None:
                stage.back(dst, buf)
            elif buf is not dst:
                dst.copy_(buf)
        if stage is not None:
            stage.done()

    return finish


# ---------------------------------------------------------------------------
# The collectives, without autograd
# ---------------------------------------------------------------------------

def shift_raw(x: torch.Tensor, ax: Axis, offset: int) -> torch.Tensor:
    """Rank ``i``'s ``x`` to rank ``i + offset`` of the axis; a rank with no
    source gets zeros (``ppermute`` with ``[(i, i + offset)]``)."""
    out = torch.zeros_like(x)
    dst, src = ax.index + offset, ax.index - offset
    sends = [(x, ax.peer(dst))] if 0 <= dst < ax.size else []
    recvs = [(out, ax.peer(src))] if 0 <= src < ax.size else []
    exchange(sends, recvs, ax.group)
    return out


def all_gather_raw(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis, in axis order."""
    out = x.new_empty(ax.size * x.numel())
    if x.numel():
        all_gather_into_tensor(out, x.detach().reshape(-1), ax.group)
    return out.view((ax.size,) + tuple(x.shape))


def psum_raw(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor)."""
    return all_reduce_(x.detach().clone(), ax.group)


# ---------------------------------------------------------------------------
# The collectives, differentiable
# ---------------------------------------------------------------------------

class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, offset):
        ctx.ax, ctx.offset = ax, offset
        return shift_raw(x, ax, offset)

    @staticmethod
    def backward(ctx, g):
        return shift_raw(g.contiguous(), ctx.ax, -ctx.offset), None, None


def shift(x: torch.Tensor, ax: Axis, offset: int = 1) -> torch.Tensor:
    """``ppermute`` by ``offset`` along the axis, zero-filled where no rank
    sends; its backward is the reverse shift."""
    return _Shift.apply(x, ax, offset)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_gather_raw(x, ax)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        return psum_raw(g, ax)[ax.index], None


def all_gather(x: torch.Tensor, ax: Axis, dim: int = 0, tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=tiled)``: every rank's
    ``x`` stacked on a new axis at ``dim`` (``tiled``: concatenated along
    ``dim``), in axis order; its backward sums the cotangents over the axis
    and keeps this rank's slice."""
    g = _AllGather.apply(x, ax)  # (n, *x.shape)
    if not tiled:
        return g.movedim(0, dim)
    return torch.cat(g.unbind(0), dim=dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, scale):
        ctx.ax, ctx.scale = ax, scale
        out = psum_raw(x, ax)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        out = psum_raw(g, ctx.ax)
        return (out * ctx.scale if ctx.scale != 1.0 else out), None, None


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the axis; its backward is ``psum`` of the cotangents."""
    return _Psum.apply(x, ax, 1.0)


def pmean(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The mean over the axis; its backward is ``pmean`` of the cotangents."""
    return _Psum.apply(x, ax, 1.0 / ax.size)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *xs):
        ctx.ax = ax
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        grads = [torch.zeros(s, dtype=d, device=v) if g is None else g
                 for g, (s, d, v) in zip(gs, ctx.meta)]
        if not grads:
            return (None,)
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        all_reduce_(flat, ctx.ax.group)
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
            off += g.numel()
        return (None, *out)


def replicated(ax: Axis, *xs: torch.Tensor) -> tuple:
    """A replicated input at the program's edge: the tensors as they are;
    backward, each one's cotangents summed over the axis (one
    ``all_reduce`` for all of them), as ``shard_map`` sums the cotangent of
    a ``P()`` input."""
    return _Replicated.apply(ax, *xs)


class _ReplicatedOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def replicated_out(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """A replicated output at the program's edge: ``x`` as it is; backward,
    the cotangent divided by the axis size, as ``shard_map`` divides the
    cotangent of a ``P()`` output (the ``psum`` transposes inside then sum
    the ``n`` ranks' shares back)."""
    return _ReplicatedOut.apply(x, ax.size)


# ---------------------------------------------------------------------------
# Pytrees
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> tuple:
    """``(leaves, treedef)``: dict leaves in sorted-key order, tuples and
    lists in order, anything else a leaf (``jax.tree_util``'s order)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return [leaf for p in parts for leaf in p[0]], ("dict", keys, [p[1] for p in parts])
    if isinstance(tree, (tuple, list)):
        parts = [tree_flatten(t) for t in tree]
        return ([leaf for p in parts for leaf in p[0]],
                (type(tree).__name__, None, [p[1] for p in parts]))
    return [tree], None


def tree_unflatten(treedef, leaves) -> object:
    """The inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(td):
        if td is None:
            return next(it)
        kind, keys, subs = td
        built = [build(s) for s in subs]
        if kind == "dict":
            return dict(zip(keys, built))
        return tuple(built) if kind == "tuple" else list(built)

    return build(treedef)
