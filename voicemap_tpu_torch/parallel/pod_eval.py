"""Pod-scale n-shot evaluation (BASELINE.json config #5).

Port of ``voicemap_tpu/parallel/pod_eval.py``: "batched embedding of the full
test-clean speaker set with sharded distance matrix", both halves over a
mesh axis:

1. **the sharded embed table**: the store's row ids, padded with id 0 to a
   multiple of the axis size, are split into contiguous shards; each rank
   embeds its shard through ``eval/nshot``'s route (B1, then the model's
   forward in bf16; B1 → B2 → B3 with ``qvars``), and
   ``all_gather_into_tensor`` assembles the table on every rank (the table
   is N×D floats; the audio never moves). The JAX program embeds a shard as
   one batch; here it goes ``embed_batch`` rows at a time, as ``embed_all``
   goes. That is a memory choice only: the evaluation forward is per row,
   so the rows come out the same;
2. **the sharded task scorers**: every rank draws the same tasks from the
   same key through ``ops/jax_random`` (the JAX package's tasks, bit for
   bit), scores its ``num_tasks / n`` of them against the table, by the
   euclidean class-mean rule or by the siamese head (``ops/distance
   .head_scores``: B9 for ``weighted_l1``), and the correct counts are
   summed with ``all_reduce``.

The model carries its parameters, so there is no ``state`` argument. With
the same key, :func:`pod_evaluate` gives the single-device
``nshot.evaluate``'s accuracy exactly.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import ExperimentConfig
from ..eval import nshot
from ..models.quant_infer import check_qvars_mode
from ..models.siamese import SiameseNet
from ..ops import jax_random, sampling
from ..train.steps import DeviceStore
from .comm import all_gather_into_tensor, all_reduce_
from .mesh import axis_group


def make_sharded_embed_table_fn(model, cfg: ExperimentConfig, mesh: DeviceMesh,
                                axis: str = "data", qvars=None,
                                embed_batch: int = 256) -> Callable:
    """``fn(store, indices (N_pad,)) → (N_pad, D)`` f32 table on every rank.

    ``indices`` (the same on every rank) must be padded to a multiple of the
    axis size (with any valid id; callers slice the result); rank ``r``
    embeds the ``r``-th contiguous shard. ``qvars`` (``models/quant_infer``)
    embeds through the int8 serving path."""
    if qvars is not None:
        check_qvars_mode(cfg, qvars)
    group, n, me = axis_group(mesh, axis)

    def embed_table(store: DeviceStore, indices: torch.Tensor) -> torch.Tensor:
        if indices.shape[0] % n:
            raise ValueError(f"{indices.shape[0]} indices do not divide the {n} ranks")
        local = indices.shape[0] // n
        mine = indices[me * local:(me + 1) * local].to(store.audio.device)
        rows = nshot.embed_rows(model, store, cfg, mine, embed_batch, qvars=qvars)
        table = rows.new_empty(n * local, rows.shape[1])
        all_gather_into_tensor(table, rows, group)
        return table

    return embed_table


def _require_key(key) -> None:
    if not jax_random.is_key(key):
        raise TypeError("the pod scorers draw every rank's tasks from one jax_random key")


def _shard_tasks(mesh: DeviceMesh, axis: str, num_tasks: int, n: int, k: int):
    """``(group, local task slice, tasks(speaker_utts, counts, key))``."""
    group, n_dev, me = axis_group(mesh, axis)
    if num_tasks % n_dev:
        raise ValueError(f"num_tasks {num_tasks} must divide mesh axis {n_dev}")
    local = num_tasks // n_dev
    mine = slice(me * local, (me + 1) * local)

    def tasks(speaker_utts, counts, key):
        _require_key(key)
        return sampling.sample_nshot_tasks(key, speaker_utts, counts, num_tasks, n, k)

    return group, mine, tasks


def _accuracy(pred: torch.Tensor, num_tasks: int, group) -> float:
    """The share of ``pred == 0`` over every rank's tasks: the correct count
    summed over the axis, then the mean of a 0/1 vector of that count (the
    single-device ``(pred == 0).float().mean()``, to the bit)."""
    correct = (pred == 0).sum().float()
    all_reduce_(correct, group)
    hits = torch.arange(num_tasks, device=pred.device) < correct
    return float(hits.float().mean())


def make_sharded_task_scorer(mesh: DeviceMesh, num_tasks: int, n: int, k: int,
                             axis: str = "data") -> Callable:
    """``fn(table, speaker_utts, counts, key) → accuracy``: tasks drawn
    alike on every rank from ``key`` (a ``jax_random`` key), each rank
    scoring its shard by the mean euclidean distance to each class's
    supports. ``num_tasks`` must divide by the axis size."""
    group, mine, tasks = _shard_tasks(mesh, axis, num_tasks, n, k)

    def score(table, speaker_utts, counts, key) -> float:
        t = tasks(speaker_utts, counts, key)
        with torch.inference_mode():
            pred = nshot.classifier_nshot_predictions(table, t.query_idx[mine],
                                                      t.support_idx[mine])
        return _accuracy(pred, num_tasks, group)

    return score


def make_sharded_siamese_scorer(mesh: DeviceMesh, num_tasks: int, n: int, k: int,
                                metric: str, same_label: int = 0,
                                axis: str = "data") -> Callable:
    """``fn(table, head_w, head_b, speaker_utts, counts, key) → accuracy``:
    the pod form of ``nshot.siamese_nshot_accuracy``, each rank scoring its
    task shard by the verification head's logits."""
    group, mine, tasks = _shard_tasks(mesh, axis, num_tasks, n, k)

    def score(table, head_w, head_b, speaker_utts, counts, key) -> float:
        t = tasks(speaker_utts, counts, key)
        with torch.inference_mode():
            pred = nshot.siamese_nshot_predictions(table, t.query_idx[mine],
                                                   t.support_idx[mine], head_w, head_b,
                                                   metric, same_label)
        return _accuracy(pred, num_tasks, group)

    return score


def pod_num_tasks(num_tasks: int, n_dev: int) -> int:
    """The task count the pod scores: rounded down to a multiple of the
    axis size, and at least one task a rank."""
    return (num_tasks // n_dev) * n_dev or n_dev


def pod_evaluate(model, store: DeviceStore, cfg: ExperimentConfig, mesh: DeviceMesh,
                 key, num_tasks: Optional[int] = None, n: Optional[int] = None,
                 k: Optional[int] = None, axis: str = "data", qvars=None,
                 embed_batch: int = 256) -> float:
    """Full pod-scale n-shot evaluation on every rank of ``axis``.

    Mode selection as ``nshot.evaluate``'s: a siamese net with a trained
    head (not contrastive, a metric the head knows) is scored by the sharded
    head scorer, every other model by embedding distance. ``qvars`` builds
    the table through the int8 serving path. ``key``: a ``jax_random`` key,
    the same on every rank."""
    _require_key(key)
    t = cfg.train
    num_tasks = num_tasks or t.num_eval_tasks
    n = n or t.n_shot
    k = k or t.k_way
    _, n_dev, _ = axis_group(mesh, axis)
    num_tasks = pod_num_tasks(num_tasks, n_dev)
    S, max_utt = store.speaker_utts.shape
    if k > S:  # before the table is embedded, as sample_nshot_tasks words it
        raise ValueError(f"k={k} exceeds the {S} available speakers")
    if n + 1 > max_utt:
        raise ValueError(f"n+1={n + 1} exceeds max utterances/speaker ({max_utt})")

    N = int(store.labels.shape[0])
    pad = (-N) % n_dev
    indices = torch.cat([torch.arange(N, dtype=torch.int32),
                         torch.zeros(pad, dtype=torch.int32)]).to(store.audio.device)
    embed = make_sharded_embed_table_fn(model, cfg, mesh, axis, qvars, embed_batch)
    table = embed(store, indices)[:N]
    if nshot.uses_head(cfg) and isinstance(model, SiameseNet):
        w, b = nshot.head_params(model)
        scorer = make_sharded_siamese_scorer(mesh, num_tasks, n, k,
                                             cfg.siamese.distance_metric,
                                             cfg.siamese.same_label, axis)
        return scorer(table, w, b, store.speaker_utts, store.speaker_counts, key)
    scorer = make_sharded_task_scorer(mesh, num_tasks, n, k, axis)
    return scorer(table, store.speaker_utts, store.speaker_counts, key)
