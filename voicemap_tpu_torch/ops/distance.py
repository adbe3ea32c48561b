"""Batched distances for n-shot evaluation and the verification head.

Port of ``voicemap_tpu/ops/distance.py``. The squared euclidean matrix is in
matmul form, ‖q‖² + ‖s‖² − 2QSᵀ; L1 has no matmul form and broadcasts. The
weighted-L1 scores of the siamese head (``pairwise_weighted_l1`` and the
``weighted_l1`` branch of ``head_scores``) go through B9
(``ops/cuda_distance.weighted_l1``): the kernel on a CUDA tensor, its plain
version, a loop over the embedding dims in the kernel's order, on a CPU one.
``merge_features`` is the per-pair merge that feeds the siamese Dense(1).
"""

from __future__ import annotations

import torch

from . import cuda_distance

SIAMESE_METRICS = (
    "uniform_euclidean",
    "weighted_l1",
    "uniform_l1",
    "dot_product",
    "cosine_distance",
)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def pairwise_sq_euclidean(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(nq, d) × (ns, d) → (nq, ns) squared euclidean, matmul form."""
    q = q.float()
    s = s.float()
    qn = (q * q).sum(-1, keepdim=True)
    sn = (s * s).sum(-1, keepdim=True).T
    return (qn + sn - 2.0 * (q @ s.T)).clamp(min=0.0)


def pairwise_euclidean(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(pairwise_sq_euclidean(q, s) + 1e-12)


def pairwise_l1(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(nq, d) × (ns, d) → (nq, ns) L1 distance (broadcast form)."""
    return (q[:, None, :] - s[None, :, :]).abs().sum(-1)


def pairwise_weighted_l1(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                         b) -> torch.Tensor:
    """Weighted-L1 verification scores ``|q − s| @ w + b`` of every pair,
    ``(nq, D) × (ns, D) → (nq, ns)`` f32, through B9."""
    return cuda_distance.weighted_l1(q[None], s[None], w, b)[0]


def pairwise_cosine_distance(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return 1.0 - _unit(q) @ _unit(s).T


def pairwise_dot(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Negative dot product (so argmin still picks the most similar)."""
    return -(q @ s.T)


def merge_features(e1: torch.Tensor, e2: torch.Tensor, metric: str) -> torch.Tensor:
    """Per-pair features of the siamese Dense(1) head: ``weighted_l1`` keeps
    the D-dim ``|e1 − e2|`` (the Dense weights it), the others collapse each
    pair to one value, ``(B, 1)``."""
    if metric == "weighted_l1":
        return (e1 - e2).abs()
    if metric == "uniform_l1":
        return (e1 - e2).abs().sum(-1, keepdim=True)
    if metric == "uniform_euclidean":
        return torch.sqrt((e1 - e2).square().sum(-1, keepdim=True) + 1e-12)
    if metric == "dot_product":
        return (e1 * e2).sum(-1, keepdim=True)
    if metric == "cosine_distance":
        return 1.0 - (_unit(e1) * _unit(e2)).sum(-1, keepdim=True)
    raise ValueError(f"unknown distance metric: {metric}")


def head_scores(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                b, metric: str) -> torch.Tensor:
    """Verification-head logits: ``q`` (T, D), ``s`` (T, P, D) → (T, P);
    ``weighted_l1`` through B9 in its ``(T, 1, P)`` form."""
    w = w.reshape(-1)
    if metric == "weighted_l1":
        return cuda_distance.weighted_l1(q[:, None, :], s, w, b)[:, 0, :]
    if metric == "uniform_l1":
        d = (q[:, None, :] - s).abs().sum(-1)
    elif metric == "uniform_euclidean":
        d = torch.sqrt((q[:, None, :] - s).square().sum(-1) + 1e-12)
    elif metric == "dot_product":
        d = torch.einsum("td,tpd->tp", q, s)
    elif metric == "cosine_distance":
        d = 1.0 - torch.einsum("td,tpd->tp", _unit(q), _unit(s))
    else:
        raise ValueError(f"unknown distance metric: {metric}")
    return d * w[0] + b


def class_distances(dist: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """(…, k*n) per-support distances → (…, k) per-class means."""
    return dist.reshape(dist.shape[:-1] + (k, n)).mean(-1)
