"""int8 post-training-quantized inference embedding (the 1D encoders and the
log-mel 2D encoder of config #4).

Port of ``voicemap_tpu/models/quant_infer.py``. The scheme is the JAX
package's, symmetric per-channel PTQ folded for an int8 GEMM:

- **Activations**: per-input-channel scales ``s_in[ci]`` from a calibration
  batch (max-abs / 127 of each block's bf16 output). Block 0's output is
  requantized inside the B2 kernel's epilogue (``requant_scale``), so blocks
  1+ stream int8 activations.
- **Weights**: the input scale is folded into the weight before it is
  quantized (``w[k,ci,co] · s_in[ci]``), then per-output-channel symmetric
  int8 (``s_w[co]``).
- **Epilogue**: conv bias, BatchNorm inference affine and the next block's
  requantization fold into ``alpha``, ``beta``, ``gamma``:
  ``z_q = clamp(round(alpha · relu(acc + beta) + gamma))``; the last block
  dequantizes (``alpha = s_w·g``, ``gamma = h``) ahead of the global max and
  the Dense, which run in ``compute_dtype``.

``quant_embed`` runs one route: B2 with ``requant_scale``, then the B3 kernel
(``ops/cuda_quant_block``) for every block 1+, at its dilation and pool 1 or
2: config #1's three blocks and config #3's (``dilated_4khz``) seven, where
the JAX package sends the dilated and pool-1 blocks to XLA's int8 conv
(``_quant_block``). The JAX package's TPU routing (``routing``,
``PALLAS_QBLOCK_*``, ``keep_pad`` and the zero-tail contract) works around
Mosaic's layout rules and is not ported; the kernels take any T. Not
ported: blocks 1+ of a kernel size other than 3, a pool above 2 or a reach
past the kernel's input box, which raise ``NotImplementedError``.

Config #4 (``quant_embed_mel``, ``kind="mel"``): the parameter-free frontend
(B6, then standardization) stays f32; the standardized image is quantized
once with a per-tensor ``s0``; all four conv2d blocks run s8×s8→s32 with the
folded epilogue; the 2×2 pool commutes with the epilogue (it is monotone
per channel), so the port pools the int32 accumulator before it, as B3
does, where the JAX package pools the int8 output; the last block
dequantizes to ``compute_dtype`` ahead of the global max and the Dense. The
JAX package leaves this conv to XLA, so the port has no kernel of its own
for it and no float conv either (cuDNN may pick inexact algorithms):
``quant_conv2d`` takes the nine shifted slices of the padded image as an
``(N, 9·Cin)`` patch matrix and multiplies it exactly, with
``torch._int_mm`` on the card and in float64 on the CPU.

A qvars dict holds ``s0`` f32 and ``blocks``, one dict per quantized block
with ``w_q`` int8 and ``alpha``, ``beta``, ``gamma`` ``(Cout,)`` f32, the
JAX package's layout: ``s0 (C0,)`` and ``w_q (3, Cin, Cout)`` for blocks 1+
of a waveform encoder; ``kind="mel"``, a 0-d ``s0`` and ``w_q (3, 3, Cin,
Cout)`` for every block of the mel encoder. ``save_qvars``/``load_qvars``
keep its ``.npz`` keys, so one artifact serves both packages.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import conv_sm90
from ..ops.cuda_conv import bn_affine, conv_block0
from ..ops.cuda_quant_block import KERNEL_TAPS, quant_block
from .convert import qvars_from_numpy
from .encoder import ConvBlock, ConvEncoder
from .spectrogram import MelSpecEncoder, run_stages, standardize

# Smallest batch at which int8 serving of the waveform encoders (config #1)
# beats bf16 on the H100. chip_smoke.py's timing phase (NVIDIA H100 80GB HBM3,
# 700 W) measured int8 faster at every batch of 1, 8, 64, 256 and 2048, store
# → embedding: 0.80 against 1.34 ms at B=1, where both are launch-bound and
# int8 launches fewer kernels (PERF.md §5). The TPU's 8 came from the v5e and
# does not carry over. It does not carry to config #4 either: there int8 is
# 1.32× slower than bf16 at B=2048 and no batch is known where it wins.
INT8_MIN_BATCH = 1


def int8_worthwhile(batch_size: int, mode: str = "classifier") -> bool:
    """Dtype-by-batch serving policy: True when int8 is expected to beat
    bf16 at this batch size (see INT8_MIN_BATCH); never for ``melspec2d``,
    until a batch where its int8 path wins is measured."""
    return mode != "melspec2d" and batch_size >= INT8_MIN_BATCH


def check_qvars_mode(cfg, qvars) -> None:
    """Validate a qvars artifact against the model mode, loudly: 'mel'
    artifacts serve melspec2d, 'wave' artifacts the waveform encoders."""
    if cfg.mode not in ("classifier", "siamese", "melspec2d"):
        raise ValueError(f"int8 path does not support mode {cfg.mode!r}")
    if (cfg.mode == "melspec2d") != (qvars.get("kind") == "mel"):
        raise ValueError(
            "qvars artifact kind does not match cfg.mode (mel artifacts "
            "serve melspec2d; wave artifacts serve classifier/siamese)"
        )


def _bn_affine(block: ConvBlock):
    """Inference BatchNorm as a per-channel affine ``z = y·g + h`` (f32)."""
    bn = block.bn
    _, g, h = bn_affine(block.conv.bias, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var, bn.eps)
    return g, h


def calibrate_scales(encoder: ConvEncoder, x_calib: torch.Tensor,
                     headroom: float = 1.0) -> List[torch.Tensor]:
    """Per-channel int8 scales of each block's input, blocks 1+.

    Runs the bf16 module forward of every block, block 0 included
    (``ConvBlock.forward_nct``, not the kernel), on ``x_calib`` and records
    the max-abs per channel of each pooled block output. ``scales[i]`` is
    the scale of block ``i+1``'s input; ``len == n_blocks - 1``.
    """
    n = len(encoder.blocks)
    out = []
    with torch.no_grad():
        h = x_calib.to(encoder.compute_dtype).transpose(1, 2)
        for i, blk in enumerate(encoder.blocks[:n - 1]):
            h = blk.forward_nct(h)
            amax = h.float().abs().amax(dim=(0, 2))
            out.append(torch.clamp(amax * headroom, min=1e-8) / 127.0)
    return out


@torch.no_grad()
def fold_scales(encoder: ConvEncoder, scales: List[torch.Tensor]) -> Dict:
    """Fold the calibrated ``scales`` into quantized weights and epilogue
    vectors of blocks 1+ → a qvars dict, in f32, op for op as the JAX
    package's ``quantize_encoder``."""
    n = len(encoder.blocks)
    blocks = []
    for i in range(1, n):
        blk = encoder.blocks[i]
        w = blk.conv.weight.float().permute(2, 1, 0)  # (k, Cin, Cout)
        b = blk.conv.bias.float()
        s_in = scales[i - 1].float().to(w.device)
        w_f = w * s_in[None, :, None]
        s_w = torch.clamp(w_f.abs().amax(dim=(0, 1)), min=1e-12) / 127.0
        w_q = torch.round(w_f / s_w[None, None, :]).clamp(-127, 127).to(torch.int8)
        g, h = _bn_affine(blk)
        beta = b / s_w
        if i < n - 1:
            s_out = scales[i].float().to(w.device)
            alpha = s_w * g / s_out
            gamma = h / s_out
        else:  # the last block dequantizes: z = (s_w·g)·relu(acc + beta) + h
            alpha = s_w * g
            gamma = h
        blocks.append({"w_q": w_q.contiguous(), "alpha": alpha, "beta": beta,
                       "gamma": gamma})
    return {"s0": scales[0].float(), "blocks": blocks}


def quantize_encoder(encoder: ConvEncoder, x_calib: torch.Tensor) -> Dict:
    """Calibrate on ``x_calib`` ``(B, T, 1)``, then fold and quantize blocks
    1+ for int8 serving. Block 0 and the Dense stay the encoder's own."""
    if len(encoder.blocks) < 2:
        raise ValueError("quantized path needs at least 2 conv blocks")
    return fold_scales(encoder, calibrate_scales(encoder, x_calib))


def quantize_from_store(model, cfg, store, n_cal: int = 256) -> Dict:
    """Calibrate and quantize off a device store: the first ``n_cal``
    deterministic (offset-0) fragments are the calibration batch.

    ``model``: a classifier (its ``encoder`` is quantized) or an encoder;
    ``cfg``: the full ExperimentConfig. ``melspec2d`` quantizes the mel
    encoder (``quantize_mel_encoder``), the other modes blocks 1+.
    """
    from ..train.steps import fetch_batch

    n = min(n_cal, int(store.labels.shape[0]))
    idx = torch.arange(n, dtype=torch.int32, device=store.audio.device)
    x_cal = fetch_batch(store, idx, cfg, stochastic=False)
    encoder = getattr(model, "encoder", model)
    if cfg.mode == "melspec2d":
        return quantize_mel_encoder(encoder, x_cal)
    return quantize_encoder(encoder, x_cal)


def quantize_from_frags(model, cfg, frags) -> Dict:
    """Calibrate and quantize off host-cut int16 fragments ``(B, frag)`` (the
    streaming serving path's calibration batch, for example the first rows
    of ``data/pipeline.iter_embed_batches``), preprocessed as the streaming
    path does (``train/steps.preprocess_fragments``). ``model`` and ``cfg``
    as for :func:`quantize_from_store`."""
    from ..train.steps import host_to_device, preprocess_fragments

    encoder = getattr(model, "encoder", model)
    x_cal = preprocess_fragments(host_to_device(frags, next(encoder.parameters()).device), cfg)
    if cfg.mode == "melspec2d":
        return quantize_mel_encoder(encoder, x_cal)
    return quantize_encoder(encoder, x_cal)


def save_qvars(path: str, qvars: Dict) -> None:
    """Write a qvars dict to one ``.npz`` serving artifact (the JAX
    package's keys: ``s0``, ``n_blocks``, ``kind``, ``block{i}_{name}``)."""
    def arr(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    arrs = {"s0": arr(qvars["s0"]),
            "n_blocks": np.asarray(len(qvars["blocks"]), np.int32),
            "kind": np.asarray(qvars.get("kind", "wave"))}
    for i, blk in enumerate(qvars["blocks"]):
        for k, v in blk.items():
            arrs[f"block{i}_{k}"] = arr(v)
    np.savez(path, **arrs)


def load_qvars(path: str, device="cuda") -> Dict:
    """Load a :func:`save_qvars` artifact (of either package) onto ``device``."""
    with np.load(path) as z:
        n = int(z["n_blocks"])
        qvars = {"s0": z["s0"],
                 "blocks": [{k: z[f"block{i}_{k}"] for k in ("w_q", "alpha", "beta", "gamma")}
                            for i in range(n)]}
        if "kind" in z and str(z["kind"]) == "mel":
            qvars["kind"] = "mel"
        return qvars_from_numpy(qvars, device)


def quant_embed(encoder: ConvEncoder, qvars: Dict, x: torch.Tensor) -> torch.Tensor:
    """``(B, T, 1)`` float32 → ``(B, embedding_dim)`` float32, int8 blocks 1+.

    Block 0 is the B2 kernel with its requantizing epilogue (bf16 GEMM, int8
    output); blocks 1+ are the B3 kernel, int8 in and out, the last one
    dequantizing to ``compute_dtype``; then the global max over time and the
    Dense in ``compute_dtype``. On CPU tensors the kernels' plain versions run.
    A mel artifact (``kind="mel"``) serves a :class:`MelSpecEncoder` through
    :func:`quant_embed_mel`.
    """
    if qvars.get("kind") == "mel":
        return quant_embed_mel(encoder, qvars, x)
    if not isinstance(encoder, ConvEncoder):
        raise ValueError("quant_embed: a waveform artifact serves a ConvEncoder")
    cfg = encoder.cfg
    n = len(encoder.blocks)
    if n < 2:
        raise ValueError("quantized path needs at least 2 conv blocks")
    if cfg.dilations[0] != 1:
        raise ValueError("quant_embed: the block-0 kernel takes dilation 1 only")
    for i in range(1, n):
        k, pool, d = cfg.kernel_sizes[i], max(cfg.pool_sizes[i], 1), cfg.dilations[i]
        if k != KERNEL_TAPS or not conv_sm90.takes(k, d, pool):
            raise NotImplementedError(
                f"quant_embed: block {i} has k={k}, pool={cfg.pool_sizes[i]}, dilation={d}; "
                f"the int8 kernel takes k={KERNEL_TAPS}, pool 1 or 2 and a reach 2d up to "
                f"{conv_sm90.MAX_REACH}")
    cdt = encoder.compute_dtype
    blk = encoder.blocks[0]
    with torch.inference_mode():
        h_q = conv_block0(
            x, blk.conv.weight.permute(2, 1, 0), blk.conv.bias, blk.bn.weight,
            blk.bn.bias, blk.bn.running_mean, blk.bn.running_var, blk.bn.eps,
            pool=blk.pool_size, gemm_dtype=cdt, requant_scale=qvars["s0"])
        for i, qblk in enumerate(qvars["blocks"], start=1):
            h_q = quant_block(h_q, qblk["w_q"], qblk["alpha"], qblk["beta"], qblk["gamma"],
                              last=i == n - 1, out_dtype=cdt, pool=max(cfg.pool_sizes[i], 1),
                              dilation=cfg.dilations[i])
        return encoder.pool_and_embed(h_q.transpose(1, 2))


# ---------------------------------------------------------------------------
# config #4 (log-mel frontend + 2D CNN, models/spectrogram.py) int8 serving
# ---------------------------------------------------------------------------
# The frontend is the encoder's own ``MelFrontend`` (the JAX package's
# ``_mel_image`` replicates it functionally to avoid a flax apply). The int8
# activations are NHWC ``(B, F, M, C)``, as in the JAX package; its
# ``_pool2d`` becomes ``pool_windows`` and the pool in ``quant_block2d``.

def pool_windows(y: torch.Tensor, pool: int) -> torch.Tensor:
    """NHWC ``(B, H, W, C)`` → the ``(B, H // p, p, W // p, p, C)`` view of its
    p×p windows, flax's VALID ``max_pool`` cut (floor); no copy."""
    h2, w2 = y.shape[1] // pool, y.shape[2] // pool
    return y[:, :h2 * pool].unflatten(1, (h2, pool))[:, :, :, :w2 * pool].unflatten(3, (w2, pool))


def quant_conv2d(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """3×3 SAME conv, s8×s8→s32, exact: ``(B, H, W, Cin)`` int8 ×
    ``(3, 3, Cin, Cout)`` int8 → ``(B, H, W, Cout)`` int32.

    The patch matrix holds the nine shifted slices of the zero-padded image,
    ``(B·H·W, 9·Cin)`` in ``w_q``'s (dy, dx, ci) order, with zero columns up
    to what ``torch._int_mm`` takes (a multiple of 8, at least 16) and zero
    rows up to its 17. On the card ``torch._int_mm`` multiplies it; on the
    CPU float64 does, where every sum here is exact (|acc| ≤ 9·Cin·127² < 2⁵³).
    """
    B, H, W, cin = x_q.shape
    cout = w_q.shape[-1]
    k = 9 * cin
    kp = max(16, -(-k // 8) * 8)
    rows = B * H * W
    xp = F.pad(x_q, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    if kp > k:
        cols.append(x_q.new_zeros((B, H, W, kp - k)))
    a = torch.cat(cols, dim=-1).reshape(rows, kp)
    del xp, cols
    if rows < 17:
        a = F.pad(a, (0, 0, 0, 17 - rows))
    w = F.pad(w_q.reshape(k, cout), (0, 0, 0, kp - k))
    if a.device.type == "cuda":
        acc = torch._int_mm(a, w.contiguous())
    else:
        acc = (a.double() @ w.double()).to(torch.int32)
    return acc[:rows].reshape(B, H, W, cout)


def quant_block2d(x_q: torch.Tensor, qblk: Dict, pool: int, *, last: bool,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """One int8 conv2d block: exact conv, the pool, then the epilogue in f32
    op by op in the JAX order ``relu(acc + beta)·alpha + gamma`` (in place),
    then int8 (round half to even, clamp ±127) or ``out_dtype`` for the last
    block.

    The JAX package pools after the epilogue. The epilogue is monotone in
    ``acc`` (nondecreasing where ``alpha > 0``, nonincreasing elsewhere, and
    every rounding on the way is monotone), so pooling the int32 accumulator
    first, max where ``alpha > 0`` and min elsewhere, gives the same output
    bit for bit with the epilogue at pool rate, as the B3 kernel does.
    """
    acc = quant_conv2d(x_q, qblk["w_q"])
    if pool > 1:
        win = pool_windows(acc, pool)
        acc = torch.where(qblk["alpha"] > 0, win.amax(dim=(2, 4)), win.amin(dim=(2, 4)))
        del win
    z = acc.float()
    del acc
    z.add_(qblk["beta"]).relu_().mul_(qblk["alpha"]).add_(qblk["gamma"])
    return z.to(out_dtype) if last else z.round_().clamp_(-127, 127).to(torch.int8)


def _mel_block_infer(h: torch.Tensor, blk) -> torch.Tensor:
    """Inference ``Conv2DBlock`` as the JAX calibration writes it, NCHW: conv
    in the compute dtype, then its bias, relu, the BN affine in f32, cast
    back, pool 2."""
    cdt = blk.compute_dtype
    z = F.conv2d(h.to(cdt), blk.conv.weight.to(cdt), padding=1) + \
        blk.conv.bias.to(cdt)[:, None, None]
    g, hh = _bn_affine(blk)
    y = (torch.relu(z).float() * g[:, None, None] + hh[:, None, None]).to(cdt)
    return F.max_pool2d(y, 2, 2)


def calibrate_mel_scales(encoder: MelSpecEncoder, x_calib: torch.Tensor,
                         headroom: float = 1.0) -> List[torch.Tensor]:
    """``scales[0]``: the per-tensor scale of the standardized image (0-d);
    ``scales[i]``, i ≥ 1: per-channel scales of block i's input, from block
    i−1's pooled output; ``len == n_blocks``."""
    with torch.no_grad():
        img = encoder.frontend(x_calib)
        out = [torch.clamp(img.abs().amax() * headroom, min=1e-8) / 127.0]
        h = img.permute(0, 3, 1, 2)
        for blk in encoder.blocks[:-1]:
            h = _mel_block_infer(h, blk)
            amax = h.float().abs().amax(dim=(0, 2, 3))
            out.append(torch.clamp(amax * headroom, min=1e-8) / 127.0)
    return out


@torch.no_grad()
def fold_mel_scales(encoder: MelSpecEncoder, scales: List[torch.Tensor]) -> Dict:
    """Fold ``scales`` into every conv2d block → a ``kind="mel"`` qvars dict,
    op for op as the JAX package's ``quantize_mel_encoder``."""
    n = len(encoder.blocks)
    blocks = []
    for i, blk in enumerate(encoder.blocks):
        w = blk.conv.weight.float().permute(2, 3, 1, 0)  # (3, 3, Cin, Cout)
        b = blk.conv.bias.float()
        s_in = torch.atleast_1d(scales[i].float().to(w.device))  # (Cin,) or (1,)
        w_f = w * s_in[None, None, :, None]
        s_w = torch.clamp(w_f.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
        w_q = torch.round(w_f / s_w).clamp(-127, 127).to(torch.int8)
        g, h = _bn_affine(blk)
        beta = b / s_w
        if i < n - 1:
            s_out = scales[i + 1].float().to(w.device)
            alpha = s_w * g / s_out
            gamma = h / s_out
        else:  # the last block dequantizes
            alpha = s_w * g
            gamma = h
        blocks.append({"w_q": w_q.contiguous(), "alpha": alpha, "beta": beta,
                       "gamma": gamma})
    return {"kind": "mel", "s0": scales[0].float(), "blocks": blocks}


def quantize_mel_encoder(encoder: MelSpecEncoder, x_calib: torch.Tensor) -> Dict:
    """Calibrate on ``x_calib`` ``(B, T, 1)``, then fold and quantize every
    conv2d block of the mel encoder for int8 serving."""
    return fold_mel_scales(encoder, calibrate_mel_scales(encoder, x_calib))


def mel_int8_stages(encoder: MelSpecEncoder, qvars: Dict) -> list:
    """``quant_embed_mel`` as ``(name, fn)`` stages: B6 and standardization in
    f32, the image quantized by ``s0``, four int8 blocks, the global max and
    the Dense in ``compute_dtype``; ``utils/stage_profile`` times each."""
    if qvars.get("kind") != "mel" or not isinstance(encoder, MelSpecEncoder):
        raise ValueError("quant_embed_mel: a mel artifact (kind='mel') serves a "
                         "MelSpecEncoder")
    cdt = encoder.compute_dtype
    n = len(qvars["blocks"])
    s0 = qvars["s0"]
    return ([("log_mel", encoder.frontend.log_mel),
             ("standardize", lambda m: standardize(m)[..., None]),
             ("quantize", lambda img: torch.round(img / s0).clamp_(-127, 127).to(torch.int8))]
            + [(f"qblock_{i}", lambda h, q=q, last=i == n - 1: quant_block2d(
                h, q, 2, last=last, out_dtype=cdt)) for i, q in enumerate(qvars["blocks"])]
            + [("global_max_dense", lambda h: encoder.pool_and_embed(h.permute(0, 3, 1, 2)))])


def quant_embed_mel(encoder: MelSpecEncoder, qvars: Dict, x: torch.Tensor) -> torch.Tensor:
    """``(B, T, 1)`` float32 → ``(B, embedding_dim)`` float32 through the int8
    conv2d stack (:func:`mel_int8_stages`)."""
    stages = mel_int8_stages(encoder, qvars)
    with torch.inference_mode():
        return run_stages(stages, x)
