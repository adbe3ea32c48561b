"""Loss functions and accuracies, from logits, in f32.

Port of ``voicemap_tpu/train/losses.py``: softmax cross-entropy for the
classifier, binary cross-entropy and the Hadsell contrastive loss for the
siamese net, and the two accuracies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy; logits ``(B,)``, labels ``(B,)`` in {0, 1}."""
    return F.binary_cross_entropy_with_logits(logits.float(), labels.float())


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def contrastive(dist: torch.Tensor, labels: torch.Tensor, margin: float = 1.0,
                same_label: int = 0) -> torch.Tensor:
    """Hadsell '06: mean(y_same·d² + (1 − y_same)·max(margin − d, 0)²), with
    ``y_same = (labels == same_label)``."""
    y_same = (labels == same_label).float()
    d = dist.float()
    return (y_same * d.square() + (1.0 - y_same) * (margin - d).clamp(min=0.0).square()).mean()


def binary_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return ((logits > 0).float() == labels.float()).float().mean()


def categorical_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels.long()).float().mean()
