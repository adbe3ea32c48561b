"""Pipeline parallelism: GPipe microbatching over a ``pp`` mesh axis.

Port of ``voicemap_tpu/parallel/pipeline_parallel.py``. S stages, one a rank
of the axis; a tick loop of ``n_micro + S − 1`` ticks in which stage ``s``
runs microbatch ``t − s`` and hands its activation to stage ``s + 1``
(``comm.shift_raw``); the last stage's outputs are summed over the axis, so
every rank holds them (the JAX ``psum`` of the masked outputs).

The JAX backward is autodiff through ``scan`` and ``ppermute``. Here the
pipeline is one ``torch.autograd.Function`` whose backward runs the ticks in
reverse: each tick takes its output's cotangent from stage ``s + 1`` through
the reverse shift, adds the outputs' cotangent on the last stage, pulls it
through the tick's saved graph (``torch.autograd.grad``) and shifts the
input's cotangent back to stage ``s − 1``. Every rank makes the same
exchanges in the same order; nothing depends on the order autograd would
pick. A tick in which a stage holds no microbatch (the bubble) computes
nothing and sends zeros: the JAX program computes those ticks, but their
results reach no output and no gradient. The outputs' cotangent is summed
over the axis and divided by S, as ``shard_map`` divides the cotangent of a
replicated output and ``psum`` transposes, so a loss of the outputs on every
rank differentiates to the sequential gradients.

- :func:`make_gpipe_fn`, :func:`make_gpipe_train_step`: homogeneous stages
  (input and output activations of one shape), ``stage_fn(params, x)``;
  each rank passes its stage's parameter shard (leaves ``(1, …)``, the
  ``P(axis)`` shard of the stacked parameters);
- :func:`make_gpipe_real_encoder_fn`, :func:`make_gpipe_real_train_step`:
  the real ``ConvEncoder`` in two stages, block 0 | blocks 1+, the global
  max and the embed. Each hop carries one padded flat f32 buffer of size
  ``A = max(mb·T, mb·T/pool₀·C₀, mb·E)``. The parameters are packed per
  stage into one flat ``(P_max,)`` row (``pack``: the flax tree's leaves in
  ``ravel_pytree``'s order, padded to the larger stage), so rank ``s``
  holds row ``s`` of the JAX package's stacked ``(2, P_max)``.
  ``train=False`` runs the shared eval trunk (``models/fast_infer``: B2 for
  block 0, B8 for blocks 1+ in bf16); ``train=True`` the port's autograd
  train block (``models/encoder.block_train_nct``, the counterpart of
  ``_jnp_block_train``, without dropout as there) with each microbatch's
  own batch statistics, and emits the raw per-microbatch (mean, var) that
  ``apply_stats`` chains into the running statistics in microbatch order.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..models.convert import variables_of
from ..models.encoder import DTYPES, block_train_nct
from ..models.fast_infer import block0_apply, blockn_apply
from . import comm
from .comm import Axis


class _Program:
    """What the tick loop needs of a pipeline: its axis and microbatches,
    the hop buffer, and per stage ``inject(x_micro, m)``, ``stage(params,
    act) → (y, stats or None)``, ``take(y)`` (the last stage's output row)
    and ``untake(g_row)`` (that row's cotangent as a hop-buffer cotangent)."""

    def __init__(self, ax: Axis, n_micro: int, hop_shape, out_shape, inject, stage, take,
                 untake, stats_size: int = 0):
        self.ax, self.n_micro = ax, n_micro
        self.hop_shape, self.out_shape = tuple(hop_shape), tuple(out_shape)
        self.inject, self.stage, self.take, self.untake = inject, stage, take, untake
        self.stats_size = stats_size


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prog: _Program, x_micro, *params):
        ax, M = prog.ax, prog.n_micro
        S, s = ax.size, ax.index
        n_ticks = M + S - 1
        dev = x_micro.device
        grad_on = any(ctx.needs_input_grad[2:])
        leaves = ([p.detach().requires_grad_(p.requires_grad) for p in params] if grad_on
                  else list(params))
        zeros = torch.zeros(prog.hop_shape, dtype=torch.float32, device=dev)
        outputs = torch.zeros((M,) + prog.out_shape, dtype=torch.float32, device=dev)
        act, saved, stats = zeros, {}, []
        for t in range(n_ticks):
            m = t - s
            real = 0 <= m < M
            y = zeros
            if real:
                if s == 0:
                    act = prog.inject(x_micro, m)
                if grad_on:
                    with torch.enable_grad():
                        a = act.detach().requires_grad_(s > 0)
                        y, st = prog.stage(leaves, a)
                    saved[t] = (a, y)
                    y = y.detach()
                else:
                    y, st = prog.stage(leaves, act)
                if st is not None:
                    stats.append(st.detach())
                if s == S - 1:
                    outputs[m] = prog.take(y)
            if t + 1 < n_ticks:
                act = comm.shift_raw(y.contiguous(), ax, 1)
        out = comm.psum_raw(outputs, ax)
        ctx.prog, ctx.leaves, ctx.saved = prog, leaves, saved
        stats = (torch.stack(stats)[None] if stats
                 else torch.zeros((1, M, prog.stats_size), device=dev))
        ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    def backward(ctx, g_out, _g_stats):
        prog, leaves, saved = ctx.prog, ctx.leaves, ctx.saved
        ax, M = prog.ax, prog.n_micro
        S, s = ax.size, ax.index
        n_ticks = M + S - 1
        g = comm.psum_raw(g_out.float(), ax) / S
        want = [p for p in leaves if p.requires_grad]
        grads = [torch.zeros_like(p) for p in want]
        pending = None  # this stage's input cotangent of the tick after
        for t in reversed(range(n_ticks)):
            ybar = (comm.shift_raw(pending, ax, -1) if pending is not None
                    else torch.zeros(prog.hop_shape, dtype=torch.float32, device=g.device))
            m = t - s
            abar = torch.zeros_like(ybar)
            if 0 <= m < M:
                if s == S - 1:
                    ybar = ybar + prog.untake(g[m])
                a, y = saved.pop(t)
                inputs = ([a] if s > 0 else []) + want
                got = torch.autograd.grad(y, inputs, ybar, allow_unused=True)
                if s > 0:
                    abar, got = got[0], got[1:]
                for acc, gi in zip(grads, got):
                    if gi is not None:
                        acc += gi
            if t > 0:
                pending = abar.contiguous()
        it = iter(grads)
        return (None, None, *(next(it) if p.requires_grad else None for p in leaves))


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def make_gpipe_fn(mesh: DeviceMesh, stage_fn: Callable, n_microbatches: int,
                  axis: str = "pp"):
    """``fn(params_local, x_micro) → y``: ``params_local`` this rank's stage
    parameters, every leaf ``(1, …)`` (the rank's shard of parameters
    stacked over S stages); ``x_micro (n_micro, mb, …)`` the same on every
    rank; ``y`` of its shape on every rank, equal to the S stages applied in
    turn to each microbatch. Differentiable in ``params_local``."""
    ax = comm.axis(mesh, axis)

    def fn(params_local, x_micro: torch.Tensor) -> torch.Tensor:
        leaves, treedef = comm.tree_flatten(params_local)
        if any(p.shape[:1] != (1,) for p in leaves):
            raise ValueError("every leaf of params_local must have a leading stage dim of 1")

        def stage(ls, act):
            return stage_fn(comm.tree_unflatten(treedef, [p[0] for p in ls]), act), None

        prog = _Program(ax, n_microbatches, x_micro.shape[1:], x_micro.shape[1:],
                        lambda x, m: x[m].float(), stage, lambda y: y, lambda g: g)
        return _GPipe.apply(prog, x_micro, *leaves)[0]

    return fn


def make_gpipe_train_step(mesh: DeviceMesh, stage_fn: Callable, loss_fn: Callable,
                          n_microbatches: int, axis: str = "pp"):
    """``step(params_local, x, y) → (loss, grads)``: ``loss_fn(outputs, y)``
    of the pipeline's outputs and its gradient in ``params_local``'s
    structure (this rank's stage), through the reversed pipeline."""
    gpipe = make_gpipe_fn(mesh, stage_fn, n_microbatches, axis=axis)

    def step(params_local, x, y):
        leaves, treedef = comm.tree_flatten(params_local)
        ps = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(gpipe(comm.tree_unflatten(treedef, ps), x), y)
        grads = torch.autograd.grad(loss, ps)
        return loss.detach(), comm.tree_unflatten(treedef, list(grads))

    return step


def _split(v: dict) -> tuple:
    p, st = v["params"], v["batch_stats"]
    v0 = {"params": {"block_0": p["block_0"]}, "batch_stats": {"block_0": st["block_0"]}}
    v1 = {"params": {k: q for k, q in p.items() if k != "block_0"},
          "batch_stats": {k: q for k, q in st.items() if k != "block_0"}}
    return v0, v1


def make_gpipe_real_encoder_fn(cfg, mesh: DeviceMesh, variables, mb: int, T: int,
                               n_microbatches: int, axis: str = "pp", train: bool = False):
    """GPipe over the real ``ConvEncoder`` in two stages (block 0 | blocks 1+,
    the global max and the embed) on a ``pp = 2`` axis; ``variables`` (a
    ``ConvEncoder`` or its flax tree) gives the layout.

    ``train=False`` → ``(fn, pack)``: ``fn(flat_local (1, P_max), x_micro
    (n_micro, mb, T, 1)) → (n_micro, mb, E)`` on both ranks, the eval
    forward; ``pack(variables) → flat_local``, this rank's stage row.

    ``train=True`` → ``(fn, pack, apply_stats)``: ``fn(...) → (out,
    stats_local (1, n_micro, G))`` with per-microbatch train-mode BatchNorm,
    each row the raw (mean, var) of this stage's blocks for one microbatch,
    padded to G; ``apply_stats(variables, stats_local)`` gathers both
    stages' rows and returns the new ``batch_stats`` tree, the running
    statistics chained ``r ← m·r + (1 − m)·stat`` in microbatch order.
    Differentiable in ``flat_local`` either way."""
    S = _axis_size(mesh, axis)
    if S != 2:
        raise ValueError(f"real-encoder pipeline is a 2-stage split; pp={S}")
    n_blocks = len(cfg.filter_multipliers)
    if n_blocks < 2:
        raise ValueError("need ≥2 conv blocks to split")
    ax = comm.axis(mesh, axis)
    s = ax.index
    cdt = DTYPES[cfg.compute_dtype]
    t1 = T // cfg.pool_sizes[0]
    c0 = cfg.filters * cfg.filter_multipliers[0]
    E = cfg.embedding_dim
    A = max(mb * T, mb * t1 * c0, mb * E)
    v_t = variables if isinstance(variables, dict) else variables_of(variables)
    layouts = []
    for part in _split(v_t):
        leaves, treedef = comm.tree_flatten(part)
        layouts.append((treedef, [tuple(p.shape) for p in leaves]))
    sizes = [sum(torch.Size(sh).numel() for sh in shapes) for _, shapes in layouts]
    P_max = max(sizes)
    chans = [cfg.filters * m for m in cfg.filter_multipliers]
    G = max(2 * chans[0], 2 * sum(chans[1:]))

    def pack(v) -> torch.Tensor:
        v = v if isinstance(v, dict) else variables_of(v)
        leaves, _ = comm.tree_flatten(_split(v)[s])
        flat = torch.cat([p.detach().reshape(-1).float() for p in leaves])
        return F.pad(flat, (0, P_max - flat.shape[0]))[None]

    def unravel(flat: torch.Tensor) -> dict:
        treedef, shapes = layouts[s]
        out, off = [], 0
        for sh in shapes:
            n = torch.Size(sh).numel()
            out.append(flat[off:off + n].view(sh))
            off += n
        return comm.tree_unflatten(treedef, out)

    def block(h: torch.Tensor, v: dict, i: int):
        """One block: train, ``(B, Cin, T)`` → ``((B, C, T'), [mu, var])``;
        eval, channels last ``(B, T, Cin)`` → ``((B, T', C), [])``."""
        blk, bst = v["params"][f"block_{i}"], v["batch_stats"][f"block_{i}"]["bn"]
        args = (blk["conv"]["kernel"], blk["conv"]["bias"], blk["bn"]["scale"],
                blk["bn"]["bias"])
        if train:
            y, mu, var = block_train_nct(h, args[0].permute(2, 1, 0), *args[1:],
                                         cfg.bn_epsilon, cfg.pool_sizes[i], cfg.dilations[i],
                                         cdt)
            return y, [mu, var]
        if i == 0:
            return block0_apply(h, *args, bst["mean"], bst["var"], cfg.bn_epsilon,
                                cfg.pool_sizes[0], cdt), []
        return blockn_apply(h, *args, bst["mean"], bst["var"], cfg.bn_epsilon,
                            cfg.pool_sizes[i], cfg.dilations[i], cdt), []

    def pad_stats(parts: list) -> Optional[torch.Tensor]:
        if not train:
            return None
        st = torch.cat([p.float() for p in parts])
        return F.pad(st, (0, G - st.shape[0]))

    def hop(y: torch.Tensor) -> torch.Tensor:
        flat = y.float().reshape(-1)
        return F.pad(flat, (0, A - flat.shape[0]))

    def stage0(ls, act):
        v = unravel(ls[0][0])
        x = act[:mb * T]
        h, st = block(x.view(mb, 1, T) if train else x.view(mb, T, 1), v, 0)
        return hop(h), pad_stats(st)

    def stage1(ls, act):
        v = unravel(ls[0][0])
        x = act[:mb * t1 * c0]
        h = x.view(mb, c0, t1).to(cdt) if train else x.view(mb, t1, c0).to(cdt)
        st = []
        for i in range(1, n_blocks):
            h, st_i = block(h, v, i)
            st += st_i
        h = h.amax(dim=2 if train else 1)
        emb = v["params"]["embed"]
        out = F.linear(h.to(cdt), emb["kernel"].t().to(cdt), emb["bias"].to(cdt))
        return hop(out), pad_stats(st)

    prog = _Program(ax, n_microbatches, (A,), (mb, E),
                    lambda x, m: hop(x[m]), stage0 if s == 0 else stage1,
                    lambda y: y[:mb * E].view(mb, E),
                    lambda g: F.pad(g.reshape(-1), (0, A - mb * E)),
                    stats_size=G)

    def fn(flat_local: torch.Tensor, x_micro: torch.Tensor):
        if flat_local.shape != (1, P_max):
            raise ValueError(f"flat_local must be (1, {P_max}), got {tuple(flat_local.shape)}")
        out, stats = _GPipe.apply(prog, x_micro, flat_local)
        return (out, stats) if train else out

    if not train:
        return fn, pack

    def apply_stats(v, stats_local: torch.Tensor) -> dict:
        """The new ``batch_stats`` tree: both stages' raw statistics gathered
        (``(2, n_micro, G)``), the running statistics of ``v`` chained over
        the microbatches in order (running statistics never feed the
        train-mode forward, so only the moving average chains)."""
        v = v if isinstance(v, dict) else variables_of(v)
        stats = comm.all_gather_raw(stats_local[0].contiguous(), ax)
        m = cfg.bn_momentum
        cur = {k: {"bn": {"mean": b["bn"]["mean"].detach().clone(),
                          "var": b["bn"]["var"].detach().clone()}}
               for k, b in v["batch_stats"].items()}
        for t in range(n_microbatches):
            row0, row1 = stats[0, t], stats[1, t]
            upd = {"block_0": (row0[:chans[0]], row0[chans[0]:2 * chans[0]])}
            off = 0
            for i in range(1, n_blocks):
                upd[f"block_{i}"] = (row1[off:off + chans[i]],
                                     row1[off + chans[i]:off + 2 * chans[i]])
                off += 2 * chans[i]
            for k, (mu, var) in upd.items():
                bn = cur[k]["bn"]
                cur[k] = {"bn": {"mean": m * bn["mean"] + (1.0 - m) * mu,
                                 "var": m * bn["var"] + (1.0 - m) * var}}
        return cur

    return fn, pack, apply_stats


def make_gpipe_real_train_step(cfg, mesh: DeviceMesh, variables, mb: int, T: int,
                               n_microbatches: int, loss_fn: Callable, axis: str = "pp"):
    """``(step, pack, apply_stats)``; ``step(flat_local, x_micro, y) →
    (loss, grads (1, P_max), stats_local)`` through the train-mode
    real-encoder pipeline: per-microbatch batch statistics in the forward,
    the gradient of this rank's stage row through the reversed pipeline;
    refresh the running statistics with ``apply_stats`` after the update."""
    gpipe, pack, apply_stats = make_gpipe_real_encoder_fn(
        cfg, mesh, variables, mb, T, n_microbatches, axis=axis, train=True)

    def step(flat_local: torch.Tensor, x_micro: torch.Tensor, y: torch.Tensor):
        p = flat_local.detach().requires_grad_()
        out, stats = gpipe(p, x_micro)
        loss = loss_fn(out, y)
        (grads,) = torch.autograd.grad(loss, [p])
        return loss.detach(), grads, stats

    return step, pack, apply_stats
