"""ECAPA-TDNN speaker embedding (Desplanques, Thienpondt and Demuynck,
Interspeech 2020), as SpeechBrain's ``ECAPA_TDNN`` builds it for
``spkrec-ecapa-voxceleb``:

    log-mel (80) − its mean over time
    → TDNN(80 → C, k 5)                                       layer 1
    → 3 × SE-Res2Net block:                                   blocks
        TDNN 1×1 → Res2Net (8-way split, y_i = tdnn_i(x_i + y_{i−1}))
        → TDNN 1×1 → squeeze-excitation gate → + the block's input
    → TDNN 1×1 over the three blocks' outputs (3C)            MFA
    → attentive statistics pooling with global context        ASP
    → BatchNorm → Linear(6C → 192)                            head

A TDNN is Conv1d (SAME) + bias → relu → BatchNorm on its running
statistics, which is B8's epilogue at pool 1 (``models/encoder.block_eval_nct``
in that order). Departures from SpeechBrain, all in the benchmark's
reference too: the convs pad SAME with zeros where SpeechBrain reflects;
there is no relative-length mask (every window is whole); the front end is
the port's log-mel (uncentred frames, Slaney filters, ``ln(power + eps)``),
not SpeechBrain's ``Fbank``.

One forward, channels last ``(B, T, C)``, takes its TDNNs from a route:

- plain (``EcapaTDNN.forward``, the CPU and ``fast=False``): each TDNN by
  ``F.conv1d`` (``encoder.block_eval_nct``), the front end by
  ``ops/melspec.log_mel_spectrogram``, ASP's TDNN on the published
  ``[h, mean, std]`` input of 3C channels;
- fast (:func:`fast_embed`, ``embed_rows(..., fast=True)``): the front end
  by B6 (``ops/cuda_melspec.log_mel``) and every TDNN by B8
  (``fast_infer.blockn_apply``), 1×1 TDNNs as one GEMM over all B·T rows.
  ASP's global context is constant in time, so its TDNN takes ``[h, u_hi,
  u_lo]``: u the mean and std columns' product with their weights (f32, per
  utterance), carried as two bf16 parts through identity weights.
  On a CPU tensor B6 and B8 run their plain versions.

The dtype policy is the other configs': parameters f32, TDNNs and the
linear layers in the compute dtype, BatchNorm, the SE gate, the softmax and
the statistics in f32. Spans (``utils/profiling.span``): ``ecapa.frontend``,
``ecapa.layer1``, ``ecapa.block.<i>`` (i = 1–3), ``ecapa.mfa``, ``ecapa.asp``,
``ecapa.head``, each at the batch's rows.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import EcapaConfig, MelConfig
from ..ops import melspec
from ..ops.cuda_melspec import log_mel
from ..utils.profiling import span
from .encoder import DTYPES, block_eval_nct
from .fast_infer import blockn_apply

STAT_EPS = 1e-12  # SpeechBrain's floor under a variance before its square root


class TDNNBlock(nn.Module):
    """Conv1d(SAME, dilation) + bias → relu → BatchNorm."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int, eps: float,
                 pdt: torch.dtype, device):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, dilation=dilation, device=device, dtype=pdt)
        self.bn = nn.BatchNorm1d(cout, eps=eps, device=device, dtype=torch.float32)


class SEBlock(nn.Module):
    """Squeeze-excitation: mean over time → C→S relu → S→C sigmoid (the
    published 1×1 convs on one step, held as Linear)."""

    def __init__(self, channels: int, se: int, pdt: torch.dtype, device):
        super().__init__()
        self.conv1 = nn.Linear(channels, se, device=device, dtype=pdt)
        self.conv2 = nn.Linear(se, channels, device=device, dtype=pdt)


class SERes2NetBlock(nn.Module):
    def __init__(self, channels: int, k: int, dilation: int, scale: int, se: int, eps: float,
                 pdt: torch.dtype, device):
        super().__init__()
        width = channels // scale
        self.tdnn1 = TDNNBlock(channels, channels, 1, 1, eps, pdt, device)
        self.res2net = nn.ModuleList(TDNNBlock(width, width, k, dilation, eps, pdt, device)
                                     for _ in range(scale - 1))
        self.tdnn2 = TDNNBlock(channels, channels, 1, 1, eps, pdt, device)
        self.se = SEBlock(channels, se, pdt, device)


class AttentiveStatisticsPooling(nn.Module):
    """TDNN(3C → A) on ``[h, mean, std]`` → tanh → 1×1 conv A → C (held as
    Linear) → softmax over time per channel → weighted mean and std (2C)."""

    def __init__(self, channels: int, attention: int, eps: float, pdt: torch.dtype, device):
        super().__init__()
        self.tdnn = TDNNBlock(3 * channels, attention, 1, 1, eps, pdt, device)
        self.conv = nn.Linear(attention, channels, device=device, dtype=pdt)


class EcapaTDNN(nn.Module):
    """Waveform ``(B, T, 1)`` float32 (÷ 32768) → embedding ``(B, D)`` float32."""

    def __init__(self, cfg: EcapaConfig, mel: MelConfig, sample_rate: int, device="cuda"):
        super().__init__()
        if len(cfg.channels) != len(cfg.kernel_sizes) or len(cfg.channels) < 3:
            raise ValueError("EcapaConfig: channels and kernel_sizes list layer 1, the "
                             "blocks and MFA")
        if cfg.channels[1] % cfg.res2net_scale:
            raise ValueError("EcapaConfig: the blocks' channels must split by res2net_scale")
        self.cfg, self.mel, self.sample_rate = cfg, mel, sample_rate
        pdt, eps = DTYPES[cfg.param_dtype], cfg.bn_epsilon
        C, ks, ds = cfg.channels, cfg.kernel_sizes, cfg.dilations
        self.layer1 = TDNNBlock(mel.n_mels, C[0], ks[0], ds[0], eps, pdt, device)
        self.blocks = nn.ModuleList(
            SERes2NetBlock(C[i], ks[i], ds[i], cfg.res2net_scale, cfg.se_channels, eps, pdt,
                           device) for i in range(1, len(C) - 1))
        self.mfa = TDNNBlock(sum(C[1:-1]), C[-1], ks[-1], ds[-1], eps, pdt, device)
        self.asp = AttentiveStatisticsPooling(C[-1], cfg.attention_channels, eps, pdt, device)
        self.asp_bn = nn.BatchNorm1d(2 * C[-1], eps=eps, device=device, dtype=torch.float32)
        self.fc = nn.Linear(2 * C[-1], cfg.embedding_dim, device=device, dtype=pdt)
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The plain forward: ``F.conv1d`` TDNNs."""
        with torch.no_grad():
            return embed(self, x, PLAIN)


# ---------------------------------------------------------------------------
# The forward, one for both routes
# ---------------------------------------------------------------------------

def _tdnn_tensors(blk: TDNNBlock) -> tuple:
    bn = blk.bn
    return (blk.conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


def tdnn_plain(blk: TDNNBlock, h: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """One TDNN by ``F.conv1d``, ``(B, T, Cin)`` → ``(B, T, Cout)`` in ``cdt``."""
    return block_eval_nct(h.transpose(1, 2), blk.conv.weight, *_tdnn_tensors(blk), 1,
                          blk.conv.dilation[0], cdt).transpose(1, 2)


def tdnn_fast(blk: TDNNBlock, h: torch.Tensor, cdt: torch.dtype,
              kernel: torch.Tensor = None) -> torch.Tensor:
    """One TDNN by B8 (``fast_infer.blockn_apply``; where B8 does not take it,
    as in f32, by ``F.conv1d``); a 1×1 TDNN as one GEMM over the B·T rows.
    ``kernel``: the weights in flax's layout ``(k, Cin, Cout)``, by default
    the block's own."""
    if kernel is None:
        kernel = blk.conv.weight.permute(2, 1, 0)
    B, T, cin = h.shape
    rows = (1, B * T, cin) if kernel.shape[0] == 1 else (B, T, cin)
    out = blockn_apply(h.reshape(rows), kernel, *_tdnn_tensors(blk), 1, blk.conv.dilation[0],
                       cdt)
    return out.reshape(B, T, -1)


def res2net(convs: nn.ModuleList, y: torch.Tensor, tdnn) -> torch.Tensor:
    """Res2Net's hierarchical chain over the channel split, in the published
    order: y_0 = x_0, y_1 = tdnn_1(x_1), y_i = tdnn_i(x_i + y_{i−1})."""
    parts = y.chunk(len(convs) + 1, dim=2)
    out = [parts[0].contiguous()]  # contiguous pieces: the cat's vectorized copy
    for i, conv in enumerate(convs, start=1):
        out.append(tdnn(conv, parts[i] if i == 1 else parts[i] + out[-1]))
    return torch.cat(out, dim=2)


def se_gate(se: SEBlock, y: torch.Tensor) -> torch.Tensor:
    """The squeeze-excitation gate ``(B, C)`` in f32."""
    s = y.mean(dim=1, dtype=torch.float32)
    s = torch.relu(F.linear(s, se.conv1.weight.float(), se.conv1.bias.float()))
    return torch.sigmoid(F.linear(s, se.conv2.weight.float(), se.conv2.bias.float()))


def se_residual(se: SEBlock, y: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """``y`` scaled by its gate, plus the block's input, in ``y``'s dtype."""
    return torch.addcmul(residual.to(y.dtype), y, se_gate(se, y).to(y.dtype)[:, None, :])


def global_stats(h: torch.Tensor) -> tuple:
    """Mean and std over time of ``(B, T, C)``, each ``(B, C)`` f32."""
    mean = h.mean(dim=1, dtype=torch.float32)
    square = torch.linalg.vector_norm(h, dim=1, dtype=torch.float32).square_() / h.shape[1]
    return mean, (square - mean * mean).clamp_(min=STAT_EPS).sqrt_()


def context_plain(tdnn_blk: TDNNBlock, h, mean, std, cdt) -> torch.Tensor:
    """ASP's TDNN on the published input ``[h, mean, std]`` (3C channels)."""
    B, T, _ = h.shape
    ctx = torch.cat([h.to(cdt), mean.to(cdt)[:, None, :].expand(B, T, -1),
                     std.to(cdt)[:, None, :].expand(B, T, -1)], dim=2)
    return tdnn_plain(tdnn_blk, ctx, cdt)


def context_fast(tdnn_blk: TDNNBlock, h, mean, std, cdt) -> torch.Tensor:
    """ASP's TDNN on ``[h, u_hi, u_lo]``: the mean and std columns enter as
    u = W_mean·mean + W_std·std, per utterance in f32, split into two
    ``cdt`` parts that identity weights add back."""
    C = h.shape[2]
    w = tdnn_blk.conv.weight[:, :, 0].float()  # (A, 3C)
    u = mean @ w[:, C:2 * C].T + std @ w[:, 2 * C:].T  # (B, A)
    hi = u.to(cdt)
    B, T, _ = h.shape
    A = u.shape[1]
    parts = torch.cat([hi, (u - hi.float()).to(cdt)], dim=1)[:, None, :]
    # contiguous pieces: the cat's vectorized copy
    x = torch.cat([h.to(cdt), parts.expand(B, T, 2 * A).contiguous()], dim=2)
    eye = torch.eye(A, device=w.device)
    kernel = torch.cat([w[:, :C].T, eye, eye])[None]  # (1, C + 2A, A)
    return tdnn_fast(tdnn_blk, x, cdt, kernel)


def attentive_stats(h: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Softmax over time per channel, then the weighted mean and std of
    ``h`` → ``(B, 2C)`` f32."""
    w = torch.softmax(logits, dim=1, dtype=torch.float32)
    wh = w.mul_(h)
    mean = wh.sum(dim=1)
    square = wh.mul_(h).sum(dim=1)
    return torch.cat([mean, (square - mean * mean).clamp_(min=STAT_EPS).sqrt_()], dim=1)


class Route:
    """How :func:`embed` computes its front end and TDNNs."""

    def __init__(self, frontend, tdnn, context):
        self.frontend, self.tdnn, self.context = frontend, tdnn, context


PLAIN = Route(melspec.log_mel_spectrogram, tdnn_plain, context_plain)
FAST = Route(log_mel, tdnn_fast, context_fast)


def frontend(model: EcapaTDNN, x: torch.Tensor, route: Route) -> torch.Tensor:
    """``(B, samples, 1)`` → log-mel less its mean over time ``(B, T, M)``
    in the compute dtype (SpeechBrain's sentence-level mean, no std)."""
    m = route.frontend(x[..., 0].float().contiguous(), model.mel, model.sample_rate)
    return (m - m.mean(dim=1, keepdim=True)).to(model.compute_dtype)


def embed(model: EcapaTDNN, x: torch.Tensor, route: Route) -> torch.Tensor:
    """The forward by ``route`` → ``(B, D)`` f32."""
    cdt, rows = model.compute_dtype, x.shape[0]
    tdnn = lambda blk, h: route.tdnn(blk, h, cdt)  # noqa: E731
    with span("embed", rows):
        with span("ecapa.frontend", rows):
            h = frontend(model, x, route)
        with span("ecapa.layer1", rows):
            h = tdnn(model.layer1, h)
        outs = []
        for i, blk in enumerate(model.blocks, start=1):
            with span(f"ecapa.block.{i}", rows):
                y = tdnn(blk.tdnn1, h)
                y = tdnn(blk.tdnn2, res2net(blk.res2net, y, tdnn))
                h = se_residual(blk.se, y, h)
            outs.append(h)
        with span("ecapa.mfa", rows):
            h = tdnn(model.mfa, torch.cat(outs, dim=2))
            del outs
        with span("ecapa.asp", rows):
            mean, std = global_stats(h)
            z = route.context(model.asp.tdnn, h, mean, std, cdt)
            conv = model.asp.conv
            logits = F.linear(torch.tanh(z), conv.weight.to(cdt), conv.bias.to(cdt))
            pooled = attentive_stats(h, logits)
        with span("ecapa.head", rows):
            bn = model.asp_bn
            pooled = F.batch_norm(pooled, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                  False, 0.0, bn.eps)
            return F.linear(pooled.to(cdt), model.fc.weight.to(cdt),
                            model.fc.bias.to(cdt)).float()


def fast_embed(model: EcapaTDNN, x: torch.Tensor) -> torch.Tensor:
    """``(B, samples, 1)`` float32 → ``(B, D)`` float32 through B6 and B8."""
    with torch.inference_mode():
        return embed(model, x, FAST)


class EcapaClassifier(nn.Module):
    """ECAPA-TDNN with SpeechBrain's cosine classifier head (the normalised
    embedding against normalised class weights), on ``SpeakerClassifier``'s
    surface: ``forward`` → logits, ``logits(emb)``, ``embed(x)``."""

    def __init__(self, cfg: EcapaConfig, mel: MelConfig, num_classes: int, sample_rate: int,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.encoder = EcapaTDNN(cfg, mel, sample_rate, device=device)
        self.head = nn.Linear(cfg.embedding_dim, num_classes, bias=False, device=device,
                              dtype=DTYPES[cfg.param_dtype])
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits(self.encoder(x))

    def logits(self, emb: torch.Tensor) -> torch.Tensor:
        """Cosine similarity of ``(B, D)`` embeddings to each class → f32."""
        return F.linear(F.normalize(emb.float()), F.normalize(self.head.weight.float()))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
