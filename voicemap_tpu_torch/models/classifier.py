"""Softmax speaker classifier head over the conv encoder (inference).

Port of ``voicemap_tpu/models/classifier.py``: encoder + Dense(num_classes)
emitting logits, and ``embed()``, the penultimate-layer embedding that
classifier-mode n-shot evaluation reads. Built on the card unless ``device``
says otherwise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import EncoderConfig
from .encoder import DTYPES, ConvEncoder


class SpeakerClassifier(nn.Module):
    def __init__(self, cfg: EncoderConfig, num_classes: int, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvEncoder(cfg, device=device)
        self.head = nn.Linear(cfg.embedding_dim, num_classes, device=device,
                              dtype=DTYPES[cfg.param_dtype])
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, 1)`` → ``(B, num_classes)`` float32 logits."""
        cdt = self.encoder.compute_dtype
        emb = self.encoder(x)
        return F.linear(emb.to(cdt), self.head.weight.to(cdt),
                        self.head.bias.to(cdt)).float()

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Penultimate-layer embedding ``(B, D)`` float32 (n-shot eval path)."""
        return self.encoder(x)
