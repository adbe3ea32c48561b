"""Threshold-free verification metrics (EER, AUC) of the siamese mode.

Port of ``voicemap_tpu/eval/verification.py``. Balanced same/different pairs
are drawn (``ops/sampling.sample_verification_batch``, the training pair
layout: on the device from a torch generator, or from a ``jax_random`` key
on the host, the JAX package's very pairs) over an embedding table, scored
so that a LOWER score means "same", and reduced to:

- the EER, where the false-accept rate over different-speaker pairs meets
  the false-reject rate over same-speaker pairs, with its threshold;
- the AUC, the chance that a random same pair scores below a random
  different pair (Mann-Whitney, ties counted half);
- their standard errors (Hanley-McNeil for the AUC, binomial for the EER).

The four metric functions are numpy, copies of the JAX package's. Scoring
follows ``eval/nshot.py``'s rule: the trained Dense(1) head for a
BCE-trained net (``ops/distance.head_scores``, so ``weighted_l1`` goes
through the B9 kernel in its ``(P, 1, 1)`` form), its logits negated when
the net was trained with ``same_label = 1``; the embeddings' euclidean
distance, in f64, for a contrastive-trained one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..ops import distance as dist_ops
from ..ops import sampling
from ..ops.sampling import Rng
from ..train.steps import DeviceStore
from . import nshot


def eer_from_scores(scores: np.ndarray, labels: np.ndarray,
                    same_label: int = 0) -> Tuple[float, float]:
    """(EER, threshold) from pair scores where a LOWER score means "same":
    every observed score is tried as the accept threshold (accept ⇔ score ≤
    t), and the EER is the mean of the two error rates where they come
    closest."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    same = np.sort(scores[labels == same_label])
    diff = np.sort(scores[labels != same_label])
    if not len(same) or not len(diff):
        raise ValueError("need both same- and different-speaker pairs")
    thr = np.unique(np.concatenate([same, diff]))
    far = np.searchsorted(diff, thr, side="right") / len(diff)
    frr = 1.0 - np.searchsorted(same, thr, side="right") / len(same)
    i = int(np.argmin(np.abs(far - frr)))
    return float((far[i] + frr[i]) / 2.0), float(thr[i])


def auc_from_scores(scores: np.ndarray, labels: np.ndarray, same_label: int = 0) -> float:
    """P(same-pair score < different-pair score), ties counted half."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    same = scores[labels == same_label]
    diff = np.sort(scores[labels != same_label])
    if not len(same) or not len(diff):
        raise ValueError("need both same- and different-speaker pairs")
    lo = np.searchsorted(diff, same, side="left")
    hi = np.searchsorted(diff, same, side="right")
    wins = lo + 0.5 * (hi - lo)  # different pairs strictly above, and half the ties
    return float((len(diff) - wins).mean() / len(diff))


def auc_stderr(auc: float, n_same: int, n_diff: int) -> float:
    """Hanley-McNeil (1982) standard error of an AUC estimate."""
    a = min(max(float(auc), 1e-9), 1.0 - 1e-9)
    q1 = a / (2.0 - a)
    q2 = 2.0 * a * a / (1.0 + a)
    var = (a * (1.0 - a) + (n_same - 1) * (q1 - a * a)
           + (n_diff - 1) * (q2 - a * a)) / (n_same * n_diff)
    return float(np.sqrt(max(var, 0.0)))


def eer_stderr(eer: float, n_same: int, n_diff: int) -> float:
    """Binomial standard error of an EER, from both error curves (FAR over
    ``n_diff`` pairs, FRR over ``n_same``)."""
    e = min(max(float(eer), 1e-9), 1.0 - 1e-9)
    return float(np.sqrt(e * (1.0 - e) * (1.0 / n_same + 1.0 / n_diff)))


def pair_scores(table: torch.Tensor, idx_1: torch.Tensor, idx_2: torch.Tensor,
                cfg: ExperimentConfig, model=None) -> torch.Tensor:
    """Scores ``(P,)`` of the pairs ``(idx_1[p], idx_2[p])`` of table rows,
    lower meaning "same": the head's logits (negated for a net trained with
    ``same_label = 1``) where ``nshot.uses_head``, else the f64 euclidean
    distance of the two embeddings."""
    with torch.inference_mode():
        q = table[idx_1.long()]
        s = table[idx_2.long()]
        if nshot.uses_head(cfg):
            w, b = nshot.head_params(model)
            logits = dist_ops.head_scores(q, s[:, None, :], w, b,
                                          cfg.siamese.distance_metric)[:, 0]
            # BCE trains sigmoid(logit) toward the label: under same = 1 a HIGH
            # logit means "same", so negate it.
            return logits if cfg.siamese.same_label == 0 else -logits
        return torch.sqrt(((q.double() - s.double()) ** 2).sum(-1))


def verification_scores(model, store: DeviceStore, cfg: ExperimentConfig,
                        generator: Rng, num_pairs: int = 1000,
                        embed_batch: int = 256, fast: bool = False, qvars=None,
                        same_label: Optional[int] = None,
                        table: Optional[torch.Tensor] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """``(scores, labels)`` of ``num_pairs`` balanced pairs, lower ⇒ same;
    ``generator`` a torch generator or a ``jax_random`` key (the JAX
    package's pairs for the same key).

    Embeds the store once (unless ``table``, an ``nshot.embed_all`` table of
    this store, cfg, fast and qvars, is given). ``same_label`` sets only the
    label VALUE of same-speaker pairs in ``labels`` (default: the config's);
    the score's orientation always follows the convention the head was
    trained with, ``cfg.siamese.same_label``.
    """
    if table is None:
        table = nshot.embed_all(model, store, cfg, batch_size=embed_batch, fast=fast,
                                qvars=qvars)
    out_same = cfg.siamese.same_label if same_label is None else int(same_label)
    batch = sampling.sample_verification_batch(generator, store.speaker_utts,
                                               store.speaker_counts, num_pairs, out_same)
    scores = pair_scores(table, batch.idx_1, batch.idx_2, cfg, model)
    return scores.cpu().numpy(), batch.labels.cpu().numpy()


def evaluate_verification(model, store: DeviceStore, cfg: ExperimentConfig,
                          generator: Rng, num_pairs: int = 1000,
                          embed_batch: int = 256, fast: bool = False, qvars=None,
                          table: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """One-call EER/AUC report over balanced same/different pairs."""
    scores, labels = verification_scores(model, store, cfg, generator, num_pairs=num_pairs,
                                         embed_batch=embed_batch, fast=fast, qvars=qvars,
                                         table=table)
    same = cfg.siamese.same_label
    err, thr = eer_from_scores(scores, labels, same)
    return {"eer": err, "eer_threshold": thr, "auc": auc_from_scores(scores, labels, same),
            "num_pairs": int(len(labels))}
