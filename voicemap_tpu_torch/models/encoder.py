"""1D-convolutional waveform encoder.

Port of ``voicemap_tpu/models/encoder.py``:

    blocks × [Conv1D(f·mult, k, same) → relu → BatchNorm → SpatialDropout1D
              → MaxPool1D] → GlobalMaxPool1D → Dense(embedding_dim)

The dtype policy is the JAX package's: parameters in ``param_dtype`` (f32),
convs, relu, pooling and the Dense in ``compute_dtype`` (bf16 by default),
BatchNorm in f32. Input ``(B, T, 1)`` float32, output ``(B, D)`` float32.
Inside, activations run channel-first ``(B, C, T)``, as ``F.conv1d`` takes
them.

In eval mode BatchNorm uses its running statistics and dropout is the
identity. In train mode each block follows flax's ``ConvBlock`` as the JAX
package's fused train forward writes it (``models/fused_train.py ::
_jnp_block_train``): BatchNorm statistics in f32 with the biased variance
``max(E[a²] − E[a]², 0)``, the normalisation folded to a per-channel affine
in the compute dtype, and the running statistics updated in place as
``m·old + (1 − m)·new`` with flax's ``m = bn_momentum`` (0.99, the fraction
kept; torch's BatchNorm update, with its momentum 0.1 and unbiased variance,
is never used). SpatialDropout1D drops whole channels, one Bernoulli draw a
(row, channel), from the ``generator`` the caller passes.

Modules are built on the card (``device="cuda"``) unless the caller asks for
another device, as the CPU tests do.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import EncoderConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def spatial_dropout(y: torch.Tensor, rate: float, generator, channel_dim: int = 1
                    ) -> torch.Tensor:
    """SpatialDropout1D: keep each (row, channel) with probability 1 − rate,
    over all of time, and scale what is kept by 1 / (1 − rate)."""
    if rate <= 0.0:
        return y
    if generator is None:
        raise ValueError("a torch.Generator is required when dropout > 0")
    keep = 1.0 - rate
    shape = [y.shape[0], 1, 1]
    shape[channel_dim] = y.shape[channel_dim]
    mask = torch.empty(shape, device=generator.device).bernoulli_(keep, generator=generator)
    return torch.where(mask.to(y.device).bool(), y / keep, 0.0).to(y.dtype)


class ConvBlock(nn.Module):
    """Conv(SAME) → relu → BatchNorm → SpatialDropout → max-pool."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 pool_size: int, dilation: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 bn_epsilon: float = 1e-3, device="cuda", dropout: float = 0.0,
                 bn_momentum: float = 0.99):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, features, kernel_size, dilation=dilation,
                              device=device, dtype=param_dtype)
        # Keras/flax epsilon (1e-3), not torch's 1e-5.
        self.bn = nn.BatchNorm1d(features, eps=bn_epsilon, device=device,
                                 dtype=torch.float32)
        self.pool_size = pool_size
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.bn_momentum = bn_momentum
        self.eval()

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        reach = self.conv.dilation[0] * (self.conv.kernel_size[0] - 1)
        # XLA's SAME: the odd one of an even reach goes on the right.
        return F.pad(x, (reach // 2, reach - reach // 2))

    def _pool(self, y: torch.Tensor) -> torch.Tensor:
        if self.pool_size > 1:
            y = F.max_pool1d(y, self.pool_size, self.pool_size)  # floor
        return y

    @torch.no_grad()
    def update_running_stats(self, mu: torch.Tensor, var: torch.Tensor) -> None:
        """flax's update, in place: ``m·old + (1 − m)·batch``."""
        m = self.bn_momentum
        for buf, new in ((self.bn.running_mean, mu), (self.bn.running_var, var)):
            buf.copy_(m * buf + (1.0 - m) * new.detach())

    def forward_nct(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``(B, Cin, T)`` → ``(B, C, T // pool)`` in the compute dtype; in
        train mode with batch statistics, dropout and the running-stats update."""
        if self.training:
            return self.forward_train_nct(x, generator)
        cdt = self.compute_dtype
        y = F.conv1d(self._pad(x.to(cdt)), self.conv.weight.to(cdt), self.conv.bias.to(cdt),
                     dilation=self.conv.dilation[0])
        y = self.bn(torch.relu(y).float()).to(cdt)
        return self._pool(y)

    def forward_train_nct(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """Train mode (``_jnp_block_train``): the conv and bias in the compute
        dtype, BatchNorm's batch statistics in f32, its affine in the compute
        dtype; updates the running statistics in place."""
        cdt = self.compute_dtype
        z = F.conv1d(self._pad(x.to(cdt)), self.conv.weight.to(cdt),
                     dilation=self.conv.dilation[0]) + self.conv.bias.to(cdt)[:, None]
        a = torch.relu(z)
        af = a.float()
        mu = af.mean((0, 2))
        var = torch.clamp((af * af).mean((0, 2)) - mu * mu, min=0.0)
        mul = self.bn.weight * torch.rsqrt(var + self.bn.eps)
        add = self.bn.bias - mu * mul
        y = a * mul.to(cdt)[:, None] + add.to(cdt)[:, None]
        y = spatial_dropout(y, self.dropout, generator)
        self.update_running_stats(mu, var)
        return self._pool(y)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``(B, T, Cin)`` → ``(B, T // pool, C)``."""
        return self.forward_nct(x.transpose(1, 2), generator).transpose(1, 2)


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
                                    cfg.bn_epsilon, device, cfg.dropout, cfg.bn_momentum))
            cin = cfg.filters * mult
        self.blocks = nn.ModuleList(blocks)
        self.embed = nn.Linear(cin, cfg.embedding_dim, device=device, dtype=pdt)
        self.compute_dtype = cdt
        self.eval()

    def pool_and_embed(self, h: torch.Tensor) -> torch.Tensor:
        """Global max over time of ``(B, C, T)``, then the Dense → ``(B, D)`` f32."""
        cdt = self.compute_dtype
        h = h.amax(dim=2)
        return F.linear(h.to(cdt), self.embed.weight.to(cdt),
                        self.embed.bias.to(cdt)).float()

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """In train mode ``generator`` draws the dropout masks, block by block."""
        h = x.to(self.compute_dtype).transpose(1, 2)
        for blk in self.blocks:
            h = blk.forward_nct(h, generator)
        return self.pool_and_embed(h)
