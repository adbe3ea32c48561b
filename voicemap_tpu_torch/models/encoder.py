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
    """Spatial dropout: keep each (row, channel) with probability 1 − rate,
    over every other axis (time; or both image axes of an NCHW tensor, as
    flax's ``Dropout(broadcast_dims=(1, 2))`` on NHWC), and scale what is
    kept by 1 / (1 − rate) in ``y``'s dtype."""
    if rate <= 0.0:
        return y
    if generator is None:
        raise ValueError("a torch.Generator is required when dropout > 0")
    keep = 1.0 - rate
    shape = [y.shape[0]] + [1] * (y.ndim - 1)
    shape[channel_dim] = y.shape[channel_dim]
    mask = torch.empty(shape, device=generator.device).bernoulli_(keep, generator=generator)
    return torch.where(mask.to(y.device).bool(), y / keep, 0.0).to(y.dtype)


@torch.no_grad()
def update_running_stats(bn: nn.Module, momentum: float, mu: torch.Tensor,
                         var: torch.Tensor) -> None:
    """flax's BatchNorm update of ``bn``'s running buffers, in place:
    ``m·old + (1 − m)·batch`` with ``m = momentum`` the fraction kept and
    ``var`` the biased batch variance."""
    for buf, new in ((bn.running_mean, mu), (bn.running_var, var)):
        buf.copy_(momentum * buf + (1.0 - momentum) * new.detach())


def same_pad(x: torch.Tensor, kernel_size: int, dilation: int = 1) -> torch.Tensor:
    """Pad the time axis (last) of ``x`` for a SAME conv, as XLA pads: the
    odd one of an even reach goes on the right."""
    reach = dilation * (kernel_size - 1)
    return F.pad(x, (reach // 2, reach - reach // 2))


def max_pool(y: torch.Tensor, pool: int) -> torch.Tensor:
    """Max-pool the time axis (last) by ``pool``, flooring the tail."""
    return F.max_pool1d(y, pool, pool) if pool > 1 else y


def block_eval_nct(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   scale: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor, eps: float, pool: int, dilation: int,
                   cdt: torch.dtype) -> torch.Tensor:
    """One block in eval mode, ``(B, Cin, T)`` → ``(B, C, T // pool)`` in
    ``cdt``: Conv(SAME) in ``cdt``, relu, BatchNorm on the running statistics
    in f32, max-pool. ``weight`` in torch's layout ``(Cout, Cin, k)``."""
    y = F.conv1d(same_pad(x.to(cdt), weight.shape[2], dilation), weight.to(cdt), bias.to(cdt),
                 dilation=dilation)
    y = F.batch_norm(torch.relu(y).float(), mean, var, scale, beta, False, 0.0, eps).to(cdt)
    return max_pool(y, pool)


def block_train_nct(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    scale: torch.Tensor, beta: torch.Tensor, eps: float, pool: int,
                    dilation: int, cdt: torch.dtype, dropout: float = 0.0,
                    generator=None) -> tuple:
    """One block in train mode (``_jnp_block_train``), ``(B, Cin, T)`` →
    ``(pooled (B, C, T // pool), mu, var)``: the conv and bias in ``cdt``,
    BatchNorm's batch statistics in f32 (the biased variance), its affine in
    ``cdt``, spatial dropout. Differentiable; updates nothing."""
    z = F.conv1d(same_pad(x.to(cdt), weight.shape[2], dilation), weight.to(cdt),
                 dilation=dilation) + bias.to(cdt)[:, None]
    a = torch.relu(z)
    af = a.float()
    mu = af.mean((0, 2))
    var = torch.clamp((af * af).mean((0, 2)) - mu * mu, min=0.0)
    mul = scale * torch.rsqrt(var + eps)
    add = beta - mu * mul
    y = a * mul.to(cdt)[:, None] + add.to(cdt)[:, None]
    y = spatial_dropout(y, dropout, generator)
    return max_pool(y, pool), mu, var


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

    def update_running_stats(self, mu: torch.Tensor, var: torch.Tensor) -> None:
        """flax's update, in place: ``m·old + (1 − m)·batch``."""
        update_running_stats(self.bn, self.bn_momentum, mu, var)

    def forward_nct(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``(B, Cin, T)`` → ``(B, C, T // pool)`` in the compute dtype; in
        train mode with batch statistics, dropout and the running-stats update."""
        if self.training:
            return self.forward_train_nct(x, generator)
        bn = self.bn
        return block_eval_nct(x, self.conv.weight, self.conv.bias, bn.weight, bn.bias,
                              bn.running_mean, bn.running_var, bn.eps, self.pool_size,
                              self.conv.dilation[0], self.compute_dtype)

    def forward_train_nct(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """Train mode (:func:`block_train_nct`); updates the running
        statistics in place."""
        y, mu, var = block_train_nct(x, self.conv.weight, self.conv.bias, self.bn.weight,
                                     self.bn.bias, self.bn.eps, self.pool_size,
                                     self.conv.dilation[0], self.compute_dtype, self.dropout,
                                     generator)
        self.update_running_stats(mu, var)
        return y

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
