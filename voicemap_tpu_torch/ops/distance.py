"""Batched distances for n-shot evaluation and the verification head.

Port of ``voicemap_tpu/ops/distance.py``. The squared euclidean matrix is in
matmul form, ‖q‖² + ‖s‖² − 2QSᵀ; L1 has no matmul form and broadcasts.
"""

from __future__ import annotations

import torch

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
                         b: torch.Tensor) -> torch.Tensor:
    """Weighted-L1 verification scores ``|q − s| @ w + b`` of every pair."""
    return (q[:, None, :] - s[None, :, :]).abs() @ w.reshape(-1) + b


def pairwise_cosine_distance(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return 1.0 - _unit(q) @ _unit(s).T


def pairwise_dot(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Negative dot product (so argmin still picks the most similar)."""
    return -(q @ s.T)


def head_scores(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, metric: str) -> torch.Tensor:
    """Verification-head logits: ``q`` (T, D), ``s`` (T, P, D) → (T, P)."""
    w = w.reshape(-1)
    if metric == "weighted_l1":
        return (q[:, None, :] - s).abs() @ w + b
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
