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

Both routes take ASP's reductions over time (:func:`global_stats`,
:func:`attentive_stats`) from ``ops/cuda_asp.asp_stats``: on the card one
pass of the kernel in each mode, the plain forward's included; on the CPU
its plain versions, the eager PyTorch it replaced. No test holds the card's
plain forward as a yardstick: the benchmark's reference
(``portbench/reference/ecapa_tdnn.py``) is independent of this module.

Training has a forward of its own (:func:`train_forward`, under autograd),
not a branch of the inference one: the front end by B6 with no gradient;
each TDNN (:func:`tdnn_train`) a GEMM over the B·T rows (1×1) or cuDNN's
conv on the channels-last view, then relu and BatchNorm on the batch's
statistics over B·T, updating the running ones (momentum ``bn.momentum``,
the unbiased variance, as ``nn.BatchNorm1d``); SE, the Res2Net chain and
the residual as in inference; ASP's TDNN on ``h`` plus the global
context's term per utterance in f32 (:func:`context_train`; gradient flows
through the global mean and std, as in SpeechBrain); ASP's statistics
through ``asp_stats``'s autograd functions (its backward kernel on the
card); ``asp_bn`` on the batch's statistics over utterances; ``fc``. B8
folds the running statistics into its epilogue, so no training TDNN takes
it.

The dtype policy is the other configs': parameters f32, TDNNs and the
linear layers in the compute dtype, BatchNorm, the SE gate, the softmax and
the statistics in f32. Spans (``utils/profiling.span``): ``ecapa.frontend``,
``ecapa.layer1``, ``ecapa.block.<i>`` (i = 1–3), ``ecapa.mfa``, ``ecapa.asp``,
``ecapa.head``, each at the batch's rows, in both forwards.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import EcapaConfig, MelConfig
from ..ops import melspec
from ..ops.cuda_asp import asp_stats
from ..ops.cuda_melspec import log_mel
from ..utils.profiling import span
from .encoder import DTYPES, block_eval_nct
from .fast_infer import blockn_apply


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
    """Mean and std over time of ``(B, T, C)``, each ``(B, C)`` f32
    (``asp_stats``'s unweighted mode; the plain route's ``h`` is a
    transposed view, which the kernel does not take)."""
    return asp_stats(h.contiguous())


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
    ``h`` → ``(B, 2C)`` f32 (``asp_stats``'s weighted mode)."""
    return asp_stats(h.contiguous(), logits.contiguous())


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    ``(N, C)`` BatchNorm's backward takes PyTorch's channels-last kernels
    only for a dense gradient, and a cat's backward hands each piece a
    strided slice."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def batch_norm_train(bn: nn.BatchNorm1d, a: torch.Tensor) -> torch.Tensor:
    """BatchNorm on the batch's statistics over every dim but the last of
    ``(B, T, C)`` or ``(B, C)``, f32 statistics, the running ones updated →
    ``a``'s dtype."""
    flat = a.reshape(-1, a.shape[-1])
    out = F.batch_norm(flat, bn.running_mean, bn.running_var, bn.weight, bn.bias, True,
                       bn.momentum, bn.eps).view(a.shape)
    return _DenseGrad.apply(out)


def tdnn_train(blk: TDNNBlock, h: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """One TDNN under autograd, ``(B, T, Cin)`` → ``(B, T, Cout)`` in
    ``cdt``: a 1×1 conv as one GEMM over the B·T rows, a wider one by
    cuDNN on the ``(B, Cin, 1, T)`` channels-last view (SAME zero padding,
    the odd one of an odd reach on the right), then relu and
    :func:`batch_norm_train`. The relu is out of place: in place on the
    GEMM's or the conv's output, a view, autograd copies the whole base
    twice in the backward, and the relu keeps its output either way."""
    w, b = blk.conv.weight.to(cdt), blk.conv.bias.to(cdt)
    k, dilation = w.shape[2], blk.conv.dilation[0]
    if k == 1:
        a = F.linear(h, w[:, :, 0], b)
    else:
        reach = dilation * (k - 1)
        if reach % 2:
            h = F.pad(h, (0, 0, reach // 2, reach - reach // 2))
        x4 = h.transpose(1, 2).unsqueeze(2)
        w4 = w.unsqueeze(2).contiguous(memory_format=torch.channels_last)
        a = F.conv2d(x4, w4, b, padding=(0, 0 if reach % 2 else reach // 2),
                     dilation=(1, dilation)).squeeze(2).transpose(1, 2)
    return batch_norm_train(blk.bn, torch.relu(a))


def context_train(tdnn_blk: TDNNBlock, h, mean, std, cdt) -> torch.Tensor:
    """ASP's TDNN under autograd → ``(B, T, A)`` f32: the GEMM of ``h``
    with the weights' first C columns in ``cdt``, plus the mean and std
    columns' term ``W_mean·mean + W_std·std + b`` per utterance in f32 (the
    published 3C-channel input without its (B, T, 3C) copy), then relu and
    :func:`batch_norm_train`."""
    C = h.shape[2]
    w = tdnn_blk.conv.weight[:, :, 0]  # (A, 3C)
    u = F.linear(mean, w[:, C:2 * C]) + F.linear(std, w[:, 2 * C:]) + tdnn_blk.conv.bias
    z = F.linear(h, w[:, :C].to(cdt)).float() + u[:, None, :]
    return batch_norm_train(tdnn_blk.bn, torch.relu(z))


def train_forward(model: EcapaTDNN, x: torch.Tensor) -> torch.Tensor:
    """The training forward, ``(B, samples, 1)`` f32 → ``(B, D)`` f32
    under autograd, BatchNorm on the batch's statistics."""
    cdt, rows = model.compute_dtype, x.shape[0]
    tdnn = lambda blk, h: tdnn_train(blk, h, cdt)  # noqa: E731
    with span("ecapa.frontend", rows):
        with torch.no_grad():
            h = frontend(model, x, FAST)
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
        z = context_train(model.asp.tdnn, h, mean, std, cdt)
        conv = model.asp.conv
        logits = F.linear(torch.tanh(z).to(cdt), conv.weight.to(cdt), conv.bias.to(cdt))
        pooled = attentive_stats(h, logits)
    with span("ecapa.head", rows):
        pooled = batch_norm_train(model.asp_bn, pooled)
        return F.linear(pooled.to(cdt), model.fc.weight.to(cdt), model.fc.bias.to(cdt)).float()


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
