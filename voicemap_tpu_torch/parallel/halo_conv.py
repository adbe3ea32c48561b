"""Sequence (time-axis) parallelism for the conv stack: halo-exchange conv1d.

Port of ``voicemap_tpu/parallel/halo_conv.py``. Long waveform fragments are
sharded along the time axis over a mesh axis; every SAME convolution needs
``(k − 1)·dilation`` neighbour samples at the shard boundaries, exchanged
with :func:`comm.shift` (zero-filled at the global edges, which is SAME's
zero padding). Max pooling stays local (every shard's length must divide
every block's pool: a shard that does not is refused, as the JAX reshape
fails; nothing is padded), the global max pool is a local max, an
``all_gather`` and a max (differentiable, as in JAX), and the Dense head is
replicated.

The functions run on every rank of the axis and take that rank's time shard
``(B, T_local, 1)``; ``variables`` is the flax tree over a model's tensors
(``models/convert.variables_of``), so gradients reach the module's
parameters. The convs are ``F.conv1d`` in f32 with TF32 off on the
halo-extended shard (VALID), as the JAX package computes
``conv_general_dilated`` in f32 outside any kernel; inside, activations run
channel first ``(B, C, T)``.

- :func:`sharded_encoder_apply` is ``ConvEncoder``'s eval forward (BN on the
  running statistics);
- :func:`sharded_encoder_train_apply` the train forward: BatchNorm's batch
  statistics (mean and mean square of the local block) are averaged over
  every axis of ``stat_axes`` inside the forward, so over ``(data, seq)``
  they are the full batch's; the new running statistics are flax's
  ``m·old + (1 − m)·batch`` with the biased variance. Spatial dropout draws
  one mask a (row, channel) per block from ``generator``: every seq rank of
  a data row must pass a generator in the same state (``parallel/dp_sp``
  seeds it by (seed, step, data index) only), so the row's shards share it;
- :func:`make_sharded_embed_fn` wraps the eval forward as ``shard_map``
  does: the parameters enter through :func:`comm.replicated` and the output
  leaves through :func:`comm.replicated_out`, so a loss of the output on
  every rank differentiates to the single-device gradients on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..config import EncoderConfig
from ..models.convert import variables_of
from ..models.encoder import max_pool, spatial_dropout
from . import comm
from .comm import Axis


@contextlib.contextmanager
def full_f32():
    """f32 convs and products with TF32 off, whatever the process set."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul


def halo_exchange(x_local: torch.Tensor, halo: int, axis: Axis, dim: int = 1) -> torch.Tensor:
    """``halo`` boundary samples from both neighbours concatenated on the time
    axis ``dim`` (zeros at the global edges): ``(B, T_local, C)`` →
    ``(B, T_local + 2·halo, C)``."""
    if halo == 0:
        return x_local
    t = x_local.shape[dim]
    if halo > t:
        raise ValueError(f"a halo of {halo} samples exceeds the {t}-sample shard")
    # my right edge → my right neighbour's left halo; my left edge → my left
    # neighbour's right halo
    left = comm.shift(x_local.narrow(dim, t - halo, halo).contiguous(), axis, 1)
    right = comm.shift(x_local.narrow(dim, 0, halo).contiguous(), axis, -1)
    return torch.cat([left, x_local, right], dim=dim)


def _halo_conv_nct(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                   axis: Axis, dilation: int) -> torch.Tensor:
    """:func:`halo_conv1d` on a channel-first shard ``(B, Cin, T_local)``."""
    reach = (kernel.shape[0] - 1) * dilation
    halo_l = reach // 2
    halo = reach - halo_l  # ≥ halo_l: the odd one of an even reach is on the right
    xh = halo_exchange(x, halo, axis, dim=2)
    start = halo - halo_l  # trim the symmetric exchange to the exact reach
    xh = xh[:, :, start:start + x.shape[2] + reach]
    with full_f32():
        return F.conv1d(xh.float(), kernel.permute(2, 1, 0).float(),
                        None if bias is None else bias.float(), dilation=dilation)


def halo_conv1d(x_local: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                axis: Axis, dilation: int = 1) -> torch.Tensor:
    """SAME conv1d over a time-sharded ``(B, T_local, Cin)`` input, f32 out.

    ``kernel`` ``(K, Cin, Cout)`` in flax's layout. An even reach pads
    asymmetrically as XLA does (15 left and 16 right for k = 32): the halo
    is exchanged at its larger side and trimmed to the exact reach."""
    return _halo_conv_nct(x_local.transpose(1, 2), kernel, bias, axis,
                          dilation).transpose(1, 2)


def _blocks(cfg: EncoderConfig):
    return enumerate(zip(cfg.kernel_sizes, cfg.pool_sizes, cfg.dilations))


def _check_pool(t: int, pool: int, i: int) -> None:
    if pool > 1 and t % pool:
        raise ValueError(f"block_{i}: the {t}-sample shard does not divide its pool {pool}")


def _global_max_and_embed(x: torch.Tensor, emb: dict, axis: Axis) -> torch.Tensor:
    """Local max over time of ``(B, C, T_local)``, the all_gather and max
    over the axis (differentiable; JAX's ``pmax`` has no JVP), the Dense in f32."""
    x = x.amax(dim=2)
    x = comm.all_gather(x, axis).amax(dim=0)
    with full_f32():
        return x @ emb["kernel"].float() + emb["bias"].float()


def sharded_encoder_apply(variables: dict, cfg: EncoderConfig, x_local: torch.Tensor,
                          axis: Axis) -> torch.Tensor:
    """Eval forward of ``ConvEncoder`` over this rank's time shard
    ``(B, T_local, 1)`` → ``(B, D)`` f32, the same on every rank of ``axis``:
    conv + relu → BN (running statistics) → max-pool per block, then the
    global max and the Dense."""
    params, stats = variables["params"], variables["batch_stats"]
    x = x_local.float().transpose(1, 2)
    for i, (k, pool, dil) in _blocks(cfg):
        blk, bst = params[f"block_{i}"], stats[f"block_{i}"]["bn"]
        x = torch.relu(_halo_conv_nct(x, blk["conv"]["kernel"], blk["conv"]["bias"], axis,
                                      dil))
        inv = torch.rsqrt(bst["var"].float() + cfg.bn_epsilon) * blk["bn"]["scale"]
        x = (x - bst["mean"][:, None]) * inv[:, None] + blk["bn"]["bias"][:, None]
        _check_pool(x.shape[2], pool, i)
        x = max_pool(x, pool)
    return _global_max_and_embed(x, params["embed"], axis)


def sharded_encoder_train_apply(params: dict, batch_stats: dict, cfg: EncoderConfig,
                                x_local: torch.Tensor, seq_axis: Axis,
                                stat_axes: Sequence[Axis],
                                generator: Optional[torch.Generator] = None) -> tuple:
    """Train forward of ``ConvEncoder`` over this rank's time shard →
    ``(embedding (B_local, D) f32, new batch_stats tree)``.

    BatchNorm's statistics reduce over the local ``(batch, time)`` block and
    over every axis of ``stat_axes`` (seq reassembles the time extent; data
    adds the other rows: with both, the single-device full-batch
    statistics); ``pmean`` inside the forward, whose backward is ``pmean``.
    ``generator`` draws the dropout masks, one a (row, channel) a block; it
    must be in the same state on every seq rank of a data row."""
    x = x_local.float().transpose(1, 2)
    new_stats: dict = {}
    m = cfg.bn_momentum
    for i, (k, pool, dil) in _blocks(cfg):
        blk, bst = params[f"block_{i}"], batch_stats[f"block_{i}"]["bn"]
        a = torch.relu(_halo_conv_nct(x, blk["conv"]["kernel"], blk["conv"]["bias"],
                                      seq_axis, dil))
        c = a.shape[1]
        moments = torch.cat([a.mean((0, 2)), (a * a).mean((0, 2))])
        for ax in stat_axes:
            moments = comm.pmean(moments, ax)
        mu, e2 = moments[:c], moments[c:]
        var = torch.clamp(e2 - mu * mu, min=0.0)
        r = torch.rsqrt(var + cfg.bn_epsilon)
        x = (a - mu[:, None]) * (blk["bn"]["scale"] * r)[:, None] + blk["bn"]["bias"][:, None]
        x = spatial_dropout(x, cfg.dropout, generator)
        _check_pool(x.shape[2], pool, i)
        x = max_pool(x, pool)
        new_stats[f"block_{i}"] = {"bn": {
            "mean": (m * bst["mean"] + (1.0 - m) * mu).detach(),
            "var": (m * bst["var"] + (1.0 - m) * var).detach()}}
    return _global_max_and_embed(x, params["embed"], seq_axis), new_stats


def make_sharded_embed_fn(cfg: EncoderConfig, mesh: DeviceMesh, axis: str = "seq"):
    """``embed(variables, x_local) → (B, D)`` f32 on every rank of ``axis``:
    ``x_local`` this rank's time shard ``(B, T / n, 1)`` (the same on the
    mesh's other axes), ``variables`` a ``ConvEncoder`` or its flax tree
    (``variables_of``). Differentiable as a ``shard_map`` is from outside."""
    ax = comm.axis(mesh, axis)

    def embed(variables, x_local: torch.Tensor) -> torch.Tensor:
        if not isinstance(variables, dict):
            variables = variables_of(variables)
        leaves, treedef = comm.tree_flatten(variables["params"])
        params = comm.tree_unflatten(treedef, comm.replicated(ax, *leaves))
        out = sharded_encoder_apply({"params": params,
                                     "batch_stats": variables["batch_stats"]},
                                    cfg, x_local, ax)
        return comm.replicated_out(out, ax)

    return embed
