"""The parallel layer: meshes over ``torch.distributed`` process groups,
multi-process initialization, the collectives of the parallel programs
(``comm``), the sharded distance matrix, pod-scale n-shot evaluation,
data-parallel training, halo-exchange sequence parallelism, data × seq
training, tensor and pipeline parallelism, and the multichip dry run
(port of ``voicemap_tpu/parallel``)."""

from . import (  # noqa: F401
    comm, data_parallel, distributed, dp_sp, halo_conv, mesh, pipeline_parallel, pod_eval,
    sharded_distance, tensor_parallel,
)
