"""1D-convolutional waveform encoder (inference).

Port of ``voicemap_tpu/models/encoder.py``:

    blocks × [Conv1D(f·mult, k, same) → relu → BatchNorm → SpatialDropout1D
              → MaxPool1D] → GlobalMaxPool1D → Dense(embedding_dim)

The dtype policy is the JAX package's: parameters in ``param_dtype`` (f32),
convs, relu, pooling and the Dense in ``compute_dtype`` (bf16 by default),
BatchNorm in f32. Input ``(B, T, 1)`` float32, output ``(B, D)`` float32.
Inside, activations run channel-first ``(B, C, T)``, as ``F.conv1d`` takes
them.

Modules are built on the card (``device="cuda"``) unless the caller asks for
another device, as the CPU tests do.

This slice is inference only: BatchNorm uses its running statistics, dropout
is the identity, and a module in train mode refuses to run. The train-mode
semantics (BatchNorm momentum and biased variance as flax has them, channel
dropout) come with the training port.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import EncoderConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _check_eval(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only the inference forward is ported; "
            "call .eval()")


class ConvBlock(nn.Module):
    """Conv(SAME) → relu → BatchNorm(running stats) → max-pool."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 pool_size: int, dilation: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 bn_epsilon: float = 1e-3, device="cuda"):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, features, kernel_size, dilation=dilation,
                              device=device, dtype=param_dtype)
        # Keras/flax epsilon (1e-3), not torch's 1e-5.
        self.bn = nn.BatchNorm1d(features, eps=bn_epsilon, device=device,
                                 dtype=torch.float32)
        self.pool_size = pool_size
        self.compute_dtype = compute_dtype
        self.eval()

    def forward_nct(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, Cin, T)`` → ``(B, C, T // pool)`` in the compute dtype."""
        _check_eval(self)
        cdt = self.compute_dtype
        reach = self.conv.dilation[0] * (self.conv.kernel_size[0] - 1)
        # XLA's SAME: the odd one of an even reach goes on the right.
        x = F.pad(x.to(cdt), (reach // 2, reach - reach // 2))
        y = F.conv1d(x, self.conv.weight.to(cdt), self.conv.bias.to(cdt),
                     dilation=self.conv.dilation[0])
        y = self.bn(torch.relu(y).float()).to(cdt)
        if self.pool_size > 1:
            y = F.max_pool1d(y, self.pool_size, self.pool_size)  # floor
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, Cin)`` → ``(B, T // pool, C)``."""
        return self.forward_nct(x.transpose(1, 2)).transpose(1, 2)


class ConvEncoder(nn.Module):
    """Waveform → embedding. Input ``(B, T, 1)`` float32; output ``(B, D)`` float32."""

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        cdt = DTYPES[cfg.compute_dtype]
        pdt = DTYPES[cfg.param_dtype]
        blocks = []
        cin = 1
        for mult, k, p, dil in zip(cfg.filter_multipliers, cfg.kernel_sizes,
                                   cfg.pool_sizes, cfg.dilations):
            blocks.append(ConvBlock(cin, cfg.filters * mult, k, p, dil, cdt, pdt,
                                    cfg.bn_epsilon, device))
            cin = cfg.filters * mult
        self.blocks = nn.ModuleList(blocks)
        self.embed = nn.Linear(cin, cfg.embedding_dim, device=device, dtype=pdt)
        self.compute_dtype = cdt
        self.eval()

    def pool_and_embed(self, h: torch.Tensor) -> torch.Tensor:
        """Global max over time of ``(B, C, T)``, then the Dense → ``(B, D)`` f32."""
        _check_eval(self)
        cdt = self.compute_dtype
        h = h.amax(dim=2)
        return F.linear(h.to(cdt), self.embed.weight.to(cdt),
                        self.embed.bias.to(cdt)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.compute_dtype).transpose(1, 2)
        for blk in self.blocks:
            h = blk.forward_nct(h)
        return self.pool_and_embed(h)
