"""Siamese verification network.

Port of ``voicemap_tpu/models/siamese.py``: two inputs → the shared conv
encoder → a distance merge (``ops/distance.merge_features``) → Dense(1),
emitting the logit of p(different) under the ``same_label = 0`` convention.

- The pair is encoded as ONE batch: ``[x1; x2]`` goes through the encoder at
  2B rows and is split after, so in train mode BatchNorm's statistics are
  taken over both halves together, as the JAX package takes them.
- The head runs in f32 whatever the compute dtype (flax's
  ``Dense(1, dtype=float32)``), unlike the classifier's, which runs in the
  compute dtype. Its input width is D for ``weighted_l1`` and 1 for the
  metrics that collapse a pair to one value.
- ``score_support`` is the head in matrix form for n-shot scoring: scores of
  every query against every support, lower meaning "same" under
  ``same_label = 0``; ``weighted_l1`` goes through the B9 kernel.

Built on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import EncoderConfig, SiameseConfig
from ..ops import distance as dist_ops
from .encoder import DTYPES, ConvEncoder


class SiameseNet(nn.Module):
    def __init__(self, cfg: EncoderConfig, siamese: SiameseConfig, device="cuda"):
        super().__init__()
        if siamese.distance_metric not in dist_ops.SIAMESE_METRICS:
            raise ValueError(f"unknown distance metric: {siamese.distance_metric}")
        self.cfg = cfg
        self.siamese = siamese
        self.encoder = ConvEncoder(cfg, device=device)
        width = cfg.embedding_dim if siamese.distance_metric == "weighted_l1" else 1
        self.head = nn.Linear(width, 1, device=device, dtype=DTYPES[cfg.param_dtype])
        self.eval()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, generator=None) -> torch.Tensor:
        """``(B, T, 1)`` × ``(B, T, 1)`` → ``(B,)`` f32 logits of p(different);
        in train mode ``generator`` draws the dropout masks."""
        B = x1.shape[0]
        emb = self.encoder(torch.cat([x1, x2], dim=0), generator)
        return self.score_pairs(emb[:B], emb[B:])

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, 1)`` → ``(B, D)`` f32 embeddings."""
        return self.encoder(x)

    def head_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """The Dense(1) on merge features, in f32 → ``(B,)``."""
        return F.linear(feats.float(), self.head.weight.float(), self.head.bias.float())[..., 0]

    def score_pairs(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        """Logits from embeddings ``(B, D) × (B, D) → (B,)``."""
        return self.head_logits(dist_ops.merge_features(e1, e2, self.siamese.distance_metric))

    @torch.no_grad()
    def score_support(self, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Score matrix ``(nq, ns)`` f32 of embeddings ``q (nq, D)``,
        ``s (ns, D)``; lower means more likely the same speaker under
        ``same_label = 0``."""
        metric = self.siamese.distance_metric
        w = self.head.weight.float()
        b = self.head.bias.float()[0]
        if metric == "weighted_l1":
            return dist_ops.pairwise_weighted_l1(q, s, w[0], b)
        if metric == "uniform_euclidean":
            d = dist_ops.pairwise_euclidean(q, s)
        elif metric == "uniform_l1":
            d = dist_ops.pairwise_l1(q, s)
        elif metric == "dot_product":
            d = -dist_ops.pairwise_dot(q, s)
        else:
            d = dist_ops.pairwise_cosine_distance(q, s)
        return d * w[0, 0] + b
