"""Batched n-shot k-way speaker-identification evaluation.

Port of ``voicemap_tpu/eval/nshot.py`` (``embed_all``,
``classifier_nshot_accuracy``, ``siamese_nshot_accuracy``, ``evaluate``,
``score_table``, ``evaluate_sweep``):

1. embed the whole evaluation store once, from deterministic offset-0
   fragments, in chunks → an ``(N, D)`` table;
2. sample every task's indices (true class at index 0): on the device from
   a ``torch.Generator`` (``fit``'s evaluation), or, from a key of
   ``ops/jax_random``, on the host through its replay of the JAX stream, the
   JAX package's very tasks (the protocol's and the CLIs'), then moved to
   the table's device;
3. score all tasks at once:
   - classifier and melspec2d modes: euclidean distance in matmul form,
     averaged per class for n > 1, argmin over classes;
   - siamese mode: the trained Dense(1) head's logits
     (``ops/distance.head_scores``; ``weighted_l1`` through the B9 kernel),
     averaged per class, argmin under ``same_label = 0`` and argmax under
     ``same_label = 1``. A contrastive-trained siamese net never trains its
     head, so it is scored by embedding distance, as the classifier is.

``fast=True`` embeds through ``models/fast_infer.fast_embed`` (the B2 kernel
for block 0 and, in bf16, the B8 kernel for blocks 1+ of k odd, pool 2 and
dilation 1); ``qvars=`` (from ``models/quant_infer``) embeds through the
int8 serving path, ``quant_embed`` (B2 with its requantizing epilogue, then
the B3 kernel for blocks 1+). Either way fragments come through the B1
kernel. The siamese net embeds as the classifier does, through its encoder.
``melspec2d`` (config #4) embeds through the model's own forward (B1, then
the B6 log-mel kernel and cuDNN's 2D convs) or, with mel ``qvars``, through
``quant_embed`` → ``quant_embed_mel``; ``fast`` does not apply to it, as in
the JAX package.

``embed_all_streaming`` builds the same table from the corpus on disk
(``data/pipeline.iter_embed_batches``: offset-0 fragments cut on the host,
in store-row order), for a corpus too large for a store on the card: each
batch goes to the card through pinned memory and is preprocessed there in
plain torch ops (``train/steps.preprocess_fragments``, no B1), then embedded
as ``embed_all`` embeds it (``fast``: B2 → B8; ``qvars``: B2 requant → B3,
or the mel int8 path; config #4: B6 in the model's forward).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..config import ExperimentConfig
from ..models.classifier import SpeakerClassifier
from ..models.fast_infer import fast_embed
from ..models.quant_infer import check_qvars_mode, quant_embed
from ..models.siamese import SiameseNet
from ..models.spectrogram import MelSpecClassifier
from ..ops import distance as dist_ops
from ..ops import jax_random, sampling
from ..ops.sampling import Rng
from ..train.steps import DeviceStore, fetch_batch


Model = Union[SpeakerClassifier, SiameseNet, MelSpecClassifier]


def embed_all(model: Model, store: DeviceStore, cfg: ExperimentConfig,
              batch_size: int = 256, fast: bool = False, qvars=None) -> torch.Tensor:
    """Embed every utterance of the store → ``(N, D)`` float32 table; with
    ``qvars``, through the int8 serving path."""
    if qvars is not None:
        check_qvars_mode(cfg, qvars)
    idx = torch.arange(store.labels.shape[0], device=store.audio.device, dtype=torch.int32)
    return embed_rows(model, store, cfg, idx, batch_size, fast, qvars)


def embed_rows(model: Model, store: DeviceStore, cfg: ExperimentConfig,
               indices: torch.Tensor, batch_size: int = 256, fast: bool = False,
               qvars=None) -> torch.Tensor:
    """Embed the store rows ``indices`` (1-D, on the store's device) from
    offset 0, ``batch_size`` at a time → ``(len(indices), D)`` float32
    (``embed_all``'s route; the caller checks ``qvars``)."""
    chunks = []
    with torch.inference_mode():
        for start in range(0, indices.shape[0], batch_size):
            x = fetch_batch(store, indices[start:start + batch_size], cfg, stochastic=False)
            chunks.append(_embed(model, cfg, x, fast, qvars))
    return torch.cat(chunks, dim=0)


def _embed(model: Model, cfg: ExperimentConfig, x: torch.Tensor, fast: bool,
           qvars) -> torch.Tensor:
    """Preprocessed fragments ``(B, T, 1)`` → embeddings by the chosen route."""
    if qvars is not None:
        return quant_embed(model.encoder, qvars, x)
    if fast and cfg.mode != "melspec2d":
        return fast_embed(model.encoder, x)
    return model.embed(x)


def embed_all_streaming(model: Model, cfg: ExperimentConfig, dataset,
                        batch_size: int = 256, fast: bool = False,
                        qvars=None) -> torch.Tensor:
    """Embed every utterance of ``dataset`` (``data/dataset.SpeakerDataset``)
    streamed from disk → ``(N, D)`` float32 table on the model's device, rows
    in dataset-id order (aligned with ``embed_all`` on the dataset's store);
    with ``qvars``, through the int8 serving path. A producer thread decodes
    ahead of the card."""
    from ..data.pipeline import iter_embed_batches
    from ..train.steps import host_to_device, preprocess_fragments

    if qvars is not None:
        check_qvars_mode(cfg, qvars)
    device = next(model.parameters()).device
    chunks = []
    with torch.inference_mode():
        for frags, count in iter_embed_batches(dataset, cfg, batch_size):
            x = preprocess_fragments(host_to_device(frags[:count], device), cfg)
            chunks.append(_embed(model, cfg, x, fast, qvars))
    return torch.cat(chunks, dim=0)


def classifier_nshot_predictions(table: torch.Tensor, query_idx: torch.Tensor,
                                 support_idx: torch.Tensor) -> torch.Tensor:
    """Predicted class ``(tasks,)`` of each task: nearest class by the mean
    euclidean distance of the query to the class's supports."""
    q = table[query_idx.long()]  # (tasks, D)
    s = table[support_idx.long()]  # (tasks, k, n, D)
    qn = (q * q).sum(-1)[:, None, None]
    sn = (s * s).sum(-1)
    cross = torch.einsum("td,tknd->tkn", q, s)
    sq = (qn + sn - 2.0 * cross).clamp(min=0.0)
    # Mean of euclidean (not squared) distances: the two orders differ for n > 1.
    return torch.sqrt(sq + 1e-12).mean(-1).argmin(-1)


def classifier_nshot_accuracy(table: torch.Tensor, speaker_utts: torch.Tensor,
                              speaker_counts: torch.Tensor, generator: Rng,
                              num_tasks: int, n: int, k: int) -> torch.Tensor:
    """Nearest-embedding n-shot accuracy (a 0-d tensor) over fresh tasks."""
    tasks = sampling.sample_nshot_tasks(generator, speaker_utts, speaker_counts,
                                        num_tasks, n, k)
    pred = classifier_nshot_predictions(table, tasks.query_idx, tasks.support_idx)
    return (pred == 0).float().mean()


def siamese_nshot_predictions(table: torch.Tensor, query_idx: torch.Tensor,
                              support_idx: torch.Tensor, w: torch.Tensor, b,
                              metric: str, same_label: int = 0) -> torch.Tensor:
    """Predicted class ``(tasks,)`` of each task by the verification head:
    its logits of the query against every support (``head_scores``), the
    mean per class, then argmin for ``same_label = 0`` (a low logit means
    "same") and argmax for ``same_label = 1``."""
    tasks, k, n = support_idx.shape
    q = table[query_idx.long()]  # (tasks, D)
    s = table[support_idx.long()].reshape(tasks, k * n, -1)  # (tasks, kn, D)
    class_scores = dist_ops.class_distances(dist_ops.head_scores(q, s, w, b, metric), n, k)
    return class_scores.argmin(-1) if same_label == 0 else class_scores.argmax(-1)


def siamese_nshot_accuracy(table: torch.Tensor, w: torch.Tensor, b,
                           speaker_utts: torch.Tensor, speaker_counts: torch.Tensor,
                           generator: Rng, num_tasks: int, n: int,
                           k: int, metric: str = "uniform_euclidean",
                           same_label: int = 0) -> torch.Tensor:
    """Verification-head n-shot accuracy (a 0-d tensor) over fresh tasks;
    ``w``, ``b`` are the Dense(1)'s weight and bias."""
    tasks = sampling.sample_nshot_tasks(generator, speaker_utts, speaker_counts,
                                        num_tasks, n, k)
    pred = siamese_nshot_predictions(table, tasks.query_idx, tasks.support_idx, w, b,
                                     metric, same_label)
    return (pred == 0).float().mean()


def uses_head(cfg: ExperimentConfig) -> bool:
    """Whether scoring reads the siamese head: in siamese mode unless the net
    was trained contrastively (its head then never trained, and scoring by
    it could even invert rankings), for a metric the head knows."""
    return (cfg.mode == "siamese" and cfg.train.loss != "contrastive"
            and cfg.siamese.distance_metric in dist_ops.SIAMESE_METRICS)


def head_params(model) -> tuple[torch.Tensor, torch.Tensor]:
    """The siamese head's ``(w (width,), b 0-d)`` in f32, detached."""
    if not isinstance(model, SiameseNet):
        raise ValueError("siamese head scoring needs the SiameseNet whose head scores")
    return model.head.weight.detach().float().reshape(-1), model.head.bias.detach().float()[0]


def score_table(table: torch.Tensor, store: DeviceStore, cfg: ExperimentConfig,
                generator: Rng, num_tasks: int, n: int, k: int,
                model: Optional[Model] = None) -> float:
    """Score one (n, k) setting against a precomputed embedding table: by
    the siamese head (``model``'s) where :func:`uses_head`, else the nearest
    class by embedding distance. ``generator``: a torch generator, or a
    ``jax_random`` key for the JAX package's tasks."""
    if cfg.mode not in ("classifier", "siamese", "melspec2d"):
        raise ValueError(f"score_table: unknown mode {cfg.mode!r}")
    with torch.inference_mode():
        if uses_head(cfg):
            w, b = head_params(model)
            acc = siamese_nshot_accuracy(table, w, b, store.speaker_utts,
                                         store.speaker_counts, generator, num_tasks, n, k,
                                         cfg.siamese.distance_metric, cfg.siamese.same_label)
        else:
            acc = classifier_nshot_accuracy(table, store.speaker_utts, store.speaker_counts,
                                            generator, num_tasks, n, k)
    return float(acc)


def evaluate(model: Model, store: DeviceStore, cfg: ExperimentConfig,
             generator: Rng, num_tasks: Optional[int] = None,
             n: Optional[int] = None, k: Optional[int] = None,
             embed_batch: int = 256, fast: bool = False, qvars=None,
             table: Optional[torch.Tensor] = None) -> float:
    """Full n-shot evaluation: embed the table once (unless given), score all
    tasks. ``generator``: a torch generator, or a ``jax_random`` key (the
    JAX package's tasks for the same key). ``qvars`` embeds through the int8
    serving path; ``table`` is a precomputed ``embed_all`` table for this
    store, cfg, fast and qvars."""
    t = cfg.train
    num_tasks = num_tasks or t.num_eval_tasks
    n = n or t.n_shot
    k = k or t.k_way
    counts = store.speaker_counts
    if k > counts.shape[0]:
        raise ValueError(
            f"k_way={k} exceeds the {counts.shape[0]} speakers in the eval store")
    min_count = int(counts.min())
    if min_count < n + 1:
        raise ValueError(
            f"n_shot={n} needs ≥{n + 1} utterances per speaker; "
            f"minimum in the eval store is {min_count}")
    if table is None:
        table = embed_all(model, store, cfg, batch_size=embed_batch, fast=fast,
                          qvars=qvars)
    return score_table(table, store, cfg, generator, num_tasks, n, k, model=model)


def evaluate_sweep(model: Model, store: DeviceStore, cfg: ExperimentConfig, key: np.ndarray,
                   n_shots: Sequence[int], k_values: Sequence[int], num_tasks: int = 500,
                   embed_batch: int = 256, fast: bool = False, qvars=None) -> list:
    """Accuracy over a grid of (n_shot, k_way) settings from ONE embedding
    table, in (n, k) grid order: ``{n_shot, k_way, num_tasks, chance,
    accuracy, stderr}`` a point. The tasks of point (n, k) come from
    ``jax_random.fold_in(key, n·1009 + k)`` (``key`` a ``jax_random`` key),
    so each point draws the JAX package's tasks for it. A setting the store
    cannot hold (k above its speakers, n + 1 above its fewest utterances a
    speaker) is not scored but carries a ``skipped`` reason, worded as the
    JAX package words it."""
    if not jax_random.is_key(key):
        raise TypeError("evaluate_sweep folds (n, k) into a jax_random key")
    counts = store.speaker_counts
    num_speakers = int(counts.shape[0])
    min_utts = int(counts.min())
    table = embed_all(model, store, cfg, batch_size=embed_batch, fast=fast, qvars=qvars)
    results = []
    for n in n_shots:
        for k in k_values:
            point = {"n_shot": int(n), "k_way": int(k),
                     "num_tasks": int(num_tasks), "chance": 1.0 / int(k)}
            if k > num_speakers:
                point["skipped"] = f"k_way={k} exceeds the {num_speakers} eval-store speakers"
            elif min_utts < n + 1:
                point["skipped"] = (f"n_shot={n} needs ≥{n + 1} utterances per speaker; "
                                    f"store minimum is {min_utts}")
            else:
                acc = score_table(table, store, cfg,
                                  jax_random.fold_in(key, int(n) * 1009 + int(k)),
                                  num_tasks, int(n), int(k), model=model)
                point["accuracy"] = acc
                point["stderr"] = float(np.sqrt(max(acc * (1.0 - acc), 1e-12) / num_tasks))
            results.append(point)
    return results
