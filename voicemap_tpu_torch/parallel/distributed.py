"""Multi-process initialization and the global mesh.

Port of ``voicemap_tpu/parallel/distributed.py``. The JAX ``initialize``
wraps ``jax.distributed.initialize``, which also finds every process's
devices; in torch only the process-group side exists, and each process
drives one device (one card, or the CPU under gloo):

- :func:`initialize` reads ``VOICEMAP_NUM_PROCESSES``, ``VOICEMAP_PROCESS_ID``
  and ``VOICEMAP_COORDINATOR`` (``host:port`` of rank 0's rendezvous), as the
  JAX one does, and is a no-op returning ``False`` for one process; else it
  joins the default group, NCCL for a card and gloo only when the caller
  asks for the CPU, and with a card takes the one its rank maps to;
- :func:`global_mesh` builds a mesh over every rank, slice-major when
  ``dcn_axis_sizes`` is given: a slice is a run of consecutive ranks (the
  process is the granule, as the JAX rig uses it on the CPU), so an axis's
  within-slice neighbours are consecutive ranks and only the named DCN axes
  cross slices.

One card takes one rank under NCCL, so a world of more than one process
needs as many cards; more processes than cards run on gloo, on the CPU or
with their tensors on a shared card (``backend="gloo"``).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from .mesh import default_device_type


def world_size() -> int:
    """The default group's size, or 1 where none is initialized."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, or 0 where none is initialized."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None) -> bool:
    """Join the default process group when running multi-process; returns
    whether distributed mode is active. Safe to call unconditionally.

    ``coordinator_address``: ``host:port`` of rank 0 (TCP), or any
    ``init_process_group`` URL (``file:///shared/rendezvous``). ``device``:
    ``"cuda"`` (NCCL; the process takes card ``process_id`` mod the cards it
    sees) or ``"cpu"`` (gloo). ``backend="gloo"`` with ``"cuda"`` keeps the
    tensors on the card and the group on gloo, whose collectives
    ``parallel/comm`` stages through the host: more ranks than cards (NCCL
    refuses two ranks on one card)."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("VOICEMAP_NUM_PROCESSES", "1"))
    if num <= 1:
        return False
    if process_id is None:
        env_pid = os.environ.get("VOICEMAP_PROCESS_ID")
        if env_pid is None:
            # torch cannot find the rank itself; defaulting to 0 would make
            # every process claim rank 0.
            raise ValueError(f"{num} processes but no process id: set VOICEMAP_PROCESS_ID "
                             "or pass process_id")
        process_id = int(env_pid)
    address = coordinator_address or os.environ.get("VOICEMAP_COORDINATOR")
    if not address:
        raise ValueError(f"{num} processes but no coordinator: set VOICEMAP_COORDINATOR "
                         "(host:port of rank 0) or pass coordinator_address")
    if "://" not in address:
        address = f"tcp://{address}"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = backend or "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=address, world_size=num, rank=process_id)
    return True


def global_mesh(axis_sizes: Optional[Dict[str, int]] = None,
                dcn_axis_sizes: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """Mesh over every rank of the default group.

    Default: a 1-D ``data`` axis over all ranks. ``axis_sizes`` must cover
    the world exactly. Multi-slice: ``axis_sizes`` gives each axis's
    within-slice extent and ``dcn_axis_sizes`` its cross-slice extent (axes
    absent there default to 1); the mesh's axis size is their product, and
    its positions are slice-major: e.g. ``global_mesh({"data": 8},
    {"data": 2})`` puts ranks 0-7 (slice 0) before ranks 8-15.
    """
    world = world_size()
    if axis_sizes is None:
        axis_sizes = {"data": world}
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    if dcn_axis_sizes is not None:
        unknown = set(dcn_axis_sizes) - set(names)
        if unknown:
            raise ValueError(f"dcn axes {unknown} not in mesh axes {names}")
        dcn_sizes = tuple(int(dcn_axis_sizes.get(n, 1)) for n in names)
        if math.prod(sizes) * math.prod(dcn_sizes) != world:
            raise ValueError(f"ici mesh {axis_sizes} × dcn mesh {dcn_axis_sizes} does not "
                             f"cover the {world} global devices")
        # ranks as (slice coordinates..., within-slice coordinates...), then
        # each axis's slice coordinate made the major part of its index
        nd = len(sizes)
        ranks = np.arange(world).reshape(dcn_sizes + sizes)
        ranks = ranks.transpose([i for d in range(nd) for i in (d, nd + d)])
        ranks = ranks.reshape([d * s for d, s in zip(dcn_sizes, sizes)])
    else:
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {axis_sizes} does not cover the {world} global devices")
        ranks = np.arange(world).reshape(sizes)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call initialize or "
                           "init_process_group first")
    return DeviceMesh(default_device_type(), torch.from_numpy(ranks), mesh_dim_names=names)


def spawn(fn: Callable, nprocs: int, args: tuple, timeout: float) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` processes started by ``spawn``
    (each imports its modules afresh); raise on a rank's error or past
    ``timeout`` seconds, and stop every process that is still alive."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
