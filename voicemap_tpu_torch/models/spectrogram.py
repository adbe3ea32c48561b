"""Log-mel frontend + 2D-CNN embedder (config #4).

Port of ``voicemap_tpu/models/spectrogram.py``:

    waveform (B, T, 1) → log-mel (B6) → per-utterance standardization
    → 4 × [Conv2D(3×3, SAME) → relu → BatchNorm → MaxPool 2×2]
    → global max over (frames, mels) → Dense(embedding_dim)

The frontend runs the B6 kernel (``ops/cuda_melspec.log_mel``) on the card
and its plain version on the CPU. Standardization is ``(m − mean) /
(std + 1e-5)`` over (frames, mels) with the population std (``jnp.std``'s
ddof 0, not ``torch.std``'s default correction 1). The dtype policy is
flax's: the image is cast to ``compute_dtype`` before block 0; each conv
runs in it with the params cast to it; BatchNorm runs in f32 with the
config's epsilon (1e-3) and is cast back before the pool; the pool floors as
flax's VALID does. The convs are cuDNN's (``F.conv2d``), as the JAX package
left them to XLA. Inside, activations are NCHW.

In train mode (``model.train()``) a block follows flax's ``Conv2DBlock``
with ``train=True``: conv (compute dtype) → relu → BatchNorm in f32 on the
batch statistics over (B, F, M), with flax's fast variance ``max(E[a²] −
E[a]², 0)`` (biased) → cast to the compute dtype → spatial dropout, one
keep/drop draw a (row, channel) from the caller's generator, broadcast over
both image axes and survivors scaled by ``1/(1 − rate)`` → max-pool 2×2. The
running statistics are updated in place as flax does, ``m·old + (1 −
m)·batch`` with ``m = bn_momentum`` (0.99) the fraction kept and the biased
variance; torch's train-mode ``BatchNorm2d`` (which keeps ``1 − momentum``
and stores the unbiased variance) is never called. The frontend has no
parameters, so no gradient reaches B6: it runs in the forward on an input
that needs none.

``MelFrontend`` returns ``(B, F, M, 1)``, the JAX layout. ``MelSpecClassifier``
has ``SpeakerClassifier``'s surface (``forward``, ``logits``, ``embed``).
Modules are built on the card unless the caller asks for another device.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import EncoderConfig, MelConfig
from ..ops import cuda_melspec
from .encoder import DTYPES, spatial_dropout, update_running_stats

STANDARDIZE_EPS = 1e-5


def standardize(m: torch.Tensor) -> torch.Tensor:
    """``(B, F, M)`` → ``(m − mean) / (std + 1e-5)`` over (F, M), population std."""
    mean = m.mean(dim=(1, 2), keepdim=True)
    std = m.std(dim=(1, 2), keepdim=True, correction=0)
    return (m - mean) / (std + STANDARDIZE_EPS)


def run_stages(stages, x):
    """Run ``(name, fn)`` stages in order, each on the previous one's output."""
    for _, fn in stages:
        x = fn(x)
    return x


class MelFrontend(nn.Module):
    """Waveform ``(B, T, 1)`` → standardized log-mel image ``(B, F, M, 1)`` f32."""

    def __init__(self, mel: MelConfig, sample_rate: int = 16000):
        super().__init__()
        self.mel = mel
        self.sample_rate = sample_rate

    def log_mel(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, 1)`` → log-mel ``(B, F, M)`` f32 (B6)."""
        # Looked up at call time, so a caller may swap in the plain version.
        return cuda_melspec.log_mel(x, self.mel, self.sample_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return standardize(self.log_mel(x))[..., None]


class Conv2DBlock(nn.Module):
    """Conv2D(3×3, SAME) → relu → BatchNorm (f32) → spatial dropout (train
    mode) → max-pool, on NCHW."""

    def __init__(self, in_channels: int, features: int, pool: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, bn_epsilon: float = 1e-3,
                 device="cuda", dropout: float = 0.0, bn_momentum: float = 0.99):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, 3, padding=1, device=device,
                              dtype=param_dtype)
        # Keras/flax epsilon (1e-3), not torch's 1e-5.
        self.bn = nn.BatchNorm2d(features, eps=bn_epsilon, device=device, dtype=torch.float32)
        self.pool = pool
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.bn_momentum = bn_momentum
        self.eval()

    def batch_norm_train(self, a: torch.Tensor) -> torch.Tensor:
        """flax's train-mode BatchNorm of ``a`` (f32, NCHW) on its batch
        statistics; updates the running statistics in place."""
        mu = a.mean((0, 2, 3))
        var = torch.clamp((a * a).mean((0, 2, 3)) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.bn.eps) * self.bn.weight
        y = (a - mu[:, None, None]) * mul[:, None, None] + self.bn.bias[:, None, None]
        update_running_stats(self.bn, self.bn_momentum, mu, var)
        return y

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``(B, Cin, F, M)`` → ``(B, C, F // pool, M // pool)`` in the compute
        dtype; in train mode ``generator`` draws the dropout mask."""
        cdt = self.compute_dtype
        y = F.conv2d(x.to(cdt), self.conv.weight.to(cdt), self.conv.bias.to(cdt), padding=1)
        a = torch.relu(y).float()
        if self.training:
            y = spatial_dropout(self.batch_norm_train(a).to(cdt), self.dropout, generator)
        else:
            y = self.bn(a).to(cdt)
        if self.pool > 1:
            y = F.max_pool2d(y, self.pool, self.pool)  # floor, as VALID
        return y


class MelSpecEncoder(nn.Module):
    """Waveform ``(B, T, 1)`` f32 → embedding ``(B, D)`` f32."""

    def __init__(self, cfg: EncoderConfig, mel: MelConfig, sample_rate: int = 16000,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        cdt = DTYPES[cfg.compute_dtype]
        pdt = DTYPES[cfg.param_dtype]
        self.frontend = MelFrontend(mel, sample_rate)
        base = max(cfg.filters // 4, 8)
        blocks, cin = [], 1
        for mult in cfg.filter_multipliers:
            blocks.append(Conv2DBlock(cin, base * mult, 2, cdt, pdt, cfg.bn_epsilon, device,
                                      cfg.dropout, cfg.bn_momentum))
            cin = base * mult
        self.blocks = nn.ModuleList(blocks)
        self.embed = nn.Linear(cin, cfg.embedding_dim, device=device, dtype=pdt)
        self.compute_dtype = cdt
        self.eval()

    def pool_and_embed(self, h: torch.Tensor) -> torch.Tensor:
        """Global max over (F, M) of ``(B, C, F, M)``, then the Dense → ``(B, D)`` f32."""
        cdt = self.compute_dtype
        h = h.amax(dim=(2, 3))
        return F.linear(h.to(cdt), self.embed.weight.to(cdt), self.embed.bias.to(cdt)).float()

    def stages(self, generator=None) -> list:
        """The forward as ``(name, fn)`` stages; ``utils/stage_profile`` times
        each of them. In train mode ``generator`` draws the dropout masks."""
        cdt = self.compute_dtype
        return ([("log_mel", self.frontend.log_mel),
                 ("standardize",  # → (B, 1, F, M) in the compute dtype
                  lambda m: standardize(m)[..., None].to(cdt).permute(0, 3, 1, 2))]
                + [(f"block_{i}", functools.partial(blk, generator=generator))
                   for i, blk in enumerate(self.blocks)]
                + [("global_max_dense", self.pool_and_embed)])

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return run_stages(self.stages(generator), x)


class MelSpecClassifier(nn.Module):
    """Frontend + 2D encoder + softmax head; ``SpeakerClassifier``'s surface."""

    def __init__(self, cfg: EncoderConfig, mel: MelConfig, num_classes: int,
                 sample_rate: int = 16000, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.encoder = MelSpecEncoder(cfg, mel, sample_rate, device=device)
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
        return F.linear(emb.to(cdt), self.head.weight.to(cdt), self.head.bias.to(cdt)).float()

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Penultimate-layer embedding ``(B, D)`` float32 (n-shot eval path)."""
        return self.encoder(x)
