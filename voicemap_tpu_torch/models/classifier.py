"""Softmax speaker classifier head over the conv encoder.

Port of ``voicemap_tpu/models/classifier.py``: encoder + Dense(num_classes)
emitting logits, in eval or train mode (the encoder's train semantics), and
``embed()``, the penultimate-layer embedding that classifier-mode n-shot
evaluation reads. Built on the card unless ``device`` says otherwise.
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

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``(B, T, 1)`` → ``(B, num_classes)`` float32 logits; in train mode
        ``generator`` draws the dropout masks."""
        return self.logits(self.encoder(x, generator))

    def logits(self, emb: torch.Tensor) -> torch.Tensor:
        """The head on ``(B, D)`` f32 embeddings, in the compute dtype → f32."""
        cdt = self.encoder.compute_dtype
        return F.linear(emb.to(cdt), self.head.weight.to(cdt),
                        self.head.bias.to(cdt)).float()

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Penultimate-layer embedding ``(B, D)`` float32 (n-shot eval path)."""
        return self.encoder(x)
