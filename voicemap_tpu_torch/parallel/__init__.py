"""The parallel layer: meshes over ``torch.distributed`` process groups,
multi-process initialization, the sharded distance matrix, pod-scale
n-shot evaluation and data-parallel training (port of
``voicemap_tpu/parallel``; its halo-exchange conv, tensor and pipeline
parallelism are not ported yet)."""

from . import data_parallel, distributed, mesh, pod_eval, sharded_distance  # noqa: F401
