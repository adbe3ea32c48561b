"""Tensor parallelism for the dense layers.

Port of ``voicemap_tpu/parallel/tensor_parallel.py``, Megatron's two forms
over a ``model`` mesh axis:

- **column-parallel**: the weight's columns sharded; the input replicated;
  each rank computes its output shard, optionally all-gathered;
- **row-parallel**: the weight's rows sharded; the input feature-sharded
  (the output of a column-parallel layer); the partial products summed with
  ``psum``.

A column → row pair is the two-layer block with one collective
(:func:`make_tp_mlp`). :func:`make_tp_encoder_embed_fn` runs the real
encoder's eval forward with its embed head column-parallel: the conv trunk
is ``models/fast_infer.fast_trunk``, the port's one shared eval trunk (B2
for block 0, then B8 in bf16 where it takes a block, ``F.conv1d``
otherwise), on this rank's rows of the ``data`` axis; each rank of ``model``
holds its ``(F, E / n)`` slice of the embed kernel. The dense products are
``torch.matmul`` in f32, as the JAX package computes them outside any kernel.

As in JAX the weights arrive whole and each ``make_tp_*`` function takes
this rank's slice of them (``in_specs``); the functions run on every rank
of the axis. :func:`make_tp_mlp` and :func:`make_tp_embed_head` are differentiable
as a ``shard_map`` is from outside (``comm.replicated`` in,
``comm.replicated_out`` out); the encoder's embed runs in inference mode,
as its kernels do.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import EncoderConfig
from ..models.fast_infer import fast_trunk
from . import comm
from .comm import Axis
from .halo_conv import full_f32


def _shard(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim`` (``P(axis)``)."""
    n = t.shape[dim]
    if n % ax.size:
        raise ValueError(f"dimension {dim} of size {n} does not divide the {ax.size} ranks "
                         "of the axis")
    return t.narrow(dim, ax.index * (n // ax.size), n // ax.size)


def column_parallel_dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                          axis: Axis, gather_output: bool = True) -> torch.Tensor:
    """``x (B, D)`` replicated × this rank's ``kernel (D, F / n)`` (+ its
    ``bias (F / n,)``) → the output shard ``(B, F / n)`` f32, or with
    ``gather_output`` all shards ``(B, F)``."""
    with full_f32():
        y = x.float() @ kernel.float()
    if bias is not None:
        y = y + bias.float()
    if gather_output:
        y = comm.all_gather(y, axis, dim=1, tiled=True)
    return y


def row_parallel_dense(x_local: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor], axis: Axis) -> torch.Tensor:
    """``x_local (B, D / n)`` × this rank's ``kernel (D / n, F)``, summed over
    the axis (+ ``bias (F,)``) → ``(B, F)`` f32 on every rank."""
    with full_f32():
        y = x_local.float() @ kernel.float()
    y = comm.psum(y, axis)
    if bias is not None:
        y = y + bias.float()
    return y


def make_tp_mlp(mesh: DeviceMesh, axis: str = "model"):
    """The two-layer block ``x → column → relu → row (psum) → y``:
    ``mlp(x (B, D), w1 (D, H), b1 (H,), w2 (H, F), b2 (F,)) → (B, F)``
    replicated, from whole weights (each rank takes its ``H / n`` slice)."""
    ax = comm.axis(mesh, axis)

    def block(x, w1, b1, w2, b2):
        x, w1, b1, w2, b2 = comm.replicated(ax, x, w1, b1, w2, b2)
        h = column_parallel_dense(x, _shard(w1, ax, 1), _shard(b1, ax, 0), ax,
                                  gather_output=False)
        y = row_parallel_dense(torch.relu(h), _shard(w2, ax, 0), None, ax) + b2.float()
        return comm.replicated_out(y, ax)

    return block


def make_tp_encoder_embed_fn(cfg: EncoderConfig, mesh: DeviceMesh, data_axis: str = "data",
                             model_axis: str = "model"):
    """``embed(encoder, x_local) → (B_local, E)`` f32: ``x_local`` this
    rank's rows ``(B / n_data, T, 1)`` of the ``data`` axis, the result
    those rows' embeddings on every rank of ``model``. The trunk is
    ``fast_trunk`` (the single-device eval trunk, bit for bit), then the
    global max and the embed Dense column-parallel over ``model`` in f32,
    its kernel and bias sliced as the JAX ``_var_specs`` slice them."""
    mesh.get_group(data_axis)  # the mesh must have both axes
    ax = comm.axis(mesh, model_axis)

    def embed(encoder, x_local: torch.Tensor) -> torch.Tensor:
        if list(encoder.cfg.filter_multipliers) != list(cfg.filter_multipliers):
            raise ValueError("the encoder's blocks are not the config's")
        with torch.inference_mode():
            h = fast_trunk(encoder, x_local).amax(dim=1).float()
            kernel = _shard(encoder.embed.weight.t(), ax, 1)
            return column_parallel_dense(h, kernel, _shard(encoder.embed.bias, ax, 0), ax)

    return embed


def make_tp_embed_head(mesh: DeviceMesh, axis: str = "model"):
    """The column-parallel embedding head: ``head(x (B, D), w (D, E), b (E,))
    → (B, E)`` replicated, from the whole weight."""
    ax = comm.axis(mesh, axis)

    def head(x, w, b):
        x, w, b = comm.replicated(ax, x, w, b)
        y = column_parallel_dense(x, _shard(w, ax, 1), _shard(b, ax, 0), ax)
        return comm.replicated_out(y, ax)

    return head
