"""The n-shot distance matrix sharded over a mesh axis (BASELINE.json
config #5).

Port of ``voicemap_tpu/parallel/sharded_distance.py``. Under ``shard_map``
the JAX functions take global arrays and hand each device its block; here
each rank passes its own block and gets its own result, and the collectives
are ``torch.distributed``'s over the axis's group. Every rank's blocks have
the same shape (the JAX specs need the sizes to divide the axis, too).

- :func:`sharded_sq_euclidean`: the queries replicated, the support sharded
  by rows; each rank computes the columns of its support block, and
  :func:`gather_columns` assembles the full ``(nq, ns)`` matrix where the
  caller asks for it;
- :func:`sharded_nearest_support`: the global argmin without the matrix:
  each rank's (min, global arg) pair per query is gathered and reduced, so
  the collective moves O(nq) scalars;
- :func:`ring_sq_euclidean`: queries and support both sharded; the query
  blocks go round the ring (``batch_isend_irecv``: send to rank + 1, receive
  from rank − 1), so after ``n`` steps each rank holds its column block of
  every row block and no rank ever holds more than 1/n of either side.

All three compute their tiles with the port's
``ops/distance.pairwise_sq_euclidean``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.distance import pairwise_sq_euclidean
from .comm import all_gather_into_tensor, exchange
from .mesh import axis_group


def gather_columns(block: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """Each rank's ``(rows, cols)`` column block → the ``(rows, n·cols)``
    matrix, blocks in rank order along the axis, on every rank."""
    group, n, _ = axis_group(mesh, axis)
    rows, cols = block.shape
    out = block.new_empty(n * rows, cols)
    all_gather_into_tensor(out, block, group)
    return out.view(n, rows, cols).permute(1, 0, 2).reshape(rows, n * cols)


def sharded_sq_euclidean(q: torch.Tensor, s_local: torch.Tensor, mesh: DeviceMesh,
                         axis: str = "data", gather: bool = True) -> torch.Tensor:
    """``q`` (nq, d) replicated × this rank's support block (ns/n, d) → the
    full ``(nq, ns)`` squared euclidean matrix (``gather``) or this rank's
    ``(nq, ns/n)`` column block."""
    block = pairwise_sq_euclidean(q, s_local)
    return gather_columns(block, mesh, axis) if gather else block


def sharded_nearest_support(q: torch.Tensor, s_local: torch.Tensor, mesh: DeviceMesh,
                            axis: str = "data") -> torch.Tensor:
    """The global nearest support row ``(nq,)`` int64 of each query, on every
    rank; a tie goes to the lowest index, as a dense argmin's does."""
    group, n, me = axis_group(mesh, axis)
    d = pairwise_sq_euclidean(q, s_local)  # (nq, ns/n)
    local_min, local_arg = d.min(dim=1)
    pair = torch.stack([local_min.double(), (local_arg + me * s_local.shape[0]).double()])
    gathered = pair.new_empty(n * 2, q.shape[0])
    all_gather_into_tensor(gathered, pair, group)
    mins, args = gathered.view(n, 2, -1).unbind(1)
    winner = mins.argmin(dim=0)  # the first minimum: the lowest shard
    return args.gather(0, winner[None]).squeeze(0).long()


def ring_sq_euclidean(q_local: torch.Tensor, s_local: torch.Tensor, mesh: DeviceMesh,
                      axis: str = "data") -> torch.Tensor:
    """This rank's query block (nq/n, d) and support block (ns/n, d) → its
    column block ``(nq, ns/n)`` of the full matrix, rows in rank order (the
    JAX function's ``P(None, axis)`` output). At step ``t`` the query block
    held came from rank ``(me − t) mod n`` and fills that rank's rows."""
    group, n, me = axis_group(mesh, axis)
    rows = q_local.shape[0]
    out = q_local.new_empty(n * rows, s_local.shape[0], dtype=torch.float32)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    blk = q_local.contiguous()
    for step in range(n):
        src = (me - step) % n
        if step + 1 < n:  # pass the block on while this tile computes
            recv = torch.empty_like(blk)
            finish = exchange([(blk, nxt)], [(recv, prv)], group, wait=False)
        out[src * rows:(src + 1) * rows] = pairwise_sq_euclidean(blk, s_local)
        if step + 1 < n:
            finish()
            blk = recv
    return out
