"""Device meshes over the default process group.

Port of ``voicemap_tpu/parallel/mesh.py :: make_mesh, data_mesh``. A device
is a rank of ``torch.distributed``'s default group (one process a card, or a
process on the CPU under gloo), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes; the programs
over it (``sharded_distance``, ``pod_eval``, ``data_parallel``) take the
process group of one axis and this rank's place on it (:func:`axis_group`).
The group must be initialized first (``parallel/distributed.initialize``,
or ``init_process_group`` by the caller, world size 1 included).

``replicated``, ``sharded`` and ``NamedSharding`` have no counterpart: a
torch tensor lives on one rank's device, so "replicated" is every rank
holding the same tensor and "sharded" every rank holding its own slice,
which the functions above say for each argument.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def default_device_type() -> str:
    """The device type of the default group's collectives: ``"cuda"`` under
    NCCL, else ``"cpu"`` (gloo)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axis_sizes: Dict[str, int]) -> DeviceMesh:
    """Mesh from ``{'axis': size}`` over the first ``prod(sizes)`` ranks, in
    rank order, on the backend's device type (:func:`default_device_type`);
    the sizes may not need more ranks than the world has."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call "
                           "parallel.distributed.initialize or init_process_group first")
    names, sizes = tuple(axis_sizes), tuple(int(s) for s in axis_sizes.values())
    total = math.prod(sizes)
    world = dist.get_world_size()
    if total > world:
        raise ValueError(f"mesh needs {total} devices, have {world}")
    ranks = torch.arange(total, dtype=torch.int64).reshape(sizes)
    return DeviceMesh(default_device_type(), ranks, mesh_dim_names=names)


def data_mesh(num_devices: Optional[int] = None) -> DeviceMesh:
    """1-D ``data`` mesh over all (or the first N) ranks."""
    return make_mesh({"data": num_devices or dist.get_world_size()})


def axis_group(mesh: DeviceMesh, axis: str) -> Tuple[dist.ProcessGroup, int, int]:
    """``(process group, size, this rank's index)`` of one named axis."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.size(dim), mesh.get_local_rank(axis)
