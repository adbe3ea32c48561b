"""Data-parallel training over a mesh axis.

Port of ``voicemap_tpu/parallel/data_parallel.py``: the four builders, with
the JAX signatures less ``state``, each returning ``(step, loss_fn)`` as the
single-device builders of ``train/steps.py`` do. They are those builders,
given the process group of the mesh's ``axis``: one step serves one rank
and many, and at world 1 the data-parallel step is the single-device step
plus an ``all_reduce`` over one rank. The JAX step's semantics are kept:

- **BatchNorm is per rank, not SyncBatchNorm**: each rank normalizes its
  sub-batch by its own batch statistics (no ``axis_name`` in the models);
  the running buffers each rank's forward updated are then averaged over
  the axis (the JAX step's ``pmean`` of ``new_bs``);
- **the gradient is averaged before the update**, so the clip by global
  norm in ``apply_updates`` sees the averaged gradient;
- **loss and accuracy** are averaged over the axis;
- **the global batch is ``cfg.train.batch_size``**; the axis size must
  divide it.

The reduction is one explicit ``all_reduce`` (a sum, then ÷ n) of one flat
f32 vector after ``backward()``: every gradient, every floating BatchNorm
buffer and the two metrics (``train/steps._mean_over_group``; why not
``DistributedDataParallel`` is said there).

Draws. The device-store steps draw their own ``batch_size / n`` sub-batch
on each rank from ``train/steps.rank_generator`` of the step's generator, a
function of (seed, step, rank). The streaming steps take the host batch
that every rank's pipeline cut alike and keep rank ``r``'s contiguous rows
``[r·B/n, (r+1)·B/n)``; only their dropout generator takes the rank. So
each rank's host decodes and cuts the whole global batch, n times the rows
it trains on: the input side of streaming DP does not scale with the ranks
(ROADMAP "Not ported yet", PERF.md §7).

On the card the local loss runs the single-device kernel route: B1 for the
device-store batch, B4/B5 for block 0, B7 around cuDNN's convs for blocks
1+ (``blockn="fused"``).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from ..config import ExperimentConfig
from ..train import steps as steps_mod


def make_dp_classifier_train_step(model, cfg: ExperimentConfig, mesh: DeviceMesh,
                                  axis: str = "data"):
    """``(step, loss_fn)``; ``step(state, store, generator) → (state,
    metrics)``: the store replicated, each rank sampling, fetching (B1) and
    training on its own ``batch_size / n`` utterances."""
    return steps_mod.make_classifier_train_step(model, cfg, mesh.get_group(axis))


def make_dp_siamese_train_step(model, cfg: ExperimentConfig, mesh: DeviceMesh,
                               axis: str = "data"):
    """Data-parallel siamese verification step (BCE or contrastive): each
    rank samples ``batch_size / n`` pairs, half alike and half differing."""
    return steps_mod.make_siamese_train_step(model, cfg, mesh.get_group(axis))


def make_dp_streaming_classifier_step(model, cfg: ExperimentConfig, mesh: DeviceMesh,
                                      axis: str = "data"):
    """``(step, loss_fn)``; ``step(state, frags (B, frag) int16, y (B,),
    generator) → (state, metrics)`` over host-streamed batches: each rank
    ships and trains on its own rows of the host batch."""
    return steps_mod.make_streaming_classifier_step(model, cfg, mesh.get_group(axis))


def make_dp_streaming_siamese_step(model, cfg: ExperimentConfig, mesh: DeviceMesh,
                                   axis: str = "data"):
    """DP siamese step over host-streamed pair fragments: ``step(state, f1,
    f2, y, generator)``."""
    return steps_mod.make_streaming_siamese_step(model, cfg, mesh.get_group(axis))
