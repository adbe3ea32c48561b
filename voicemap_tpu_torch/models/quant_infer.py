"""int8 post-training-quantized inference embedding (the 1D encoders).

Port of the waveform half of ``voicemap_tpu/models/quant_infer.py``. The
scheme is the JAX package's, symmetric per-channel PTQ folded for an int8
GEMM:

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
(``ops/cuda_quant_block``) for every block 1+. The JAX package's TPU routing
(``routing``, ``PALLAS_QBLOCK_*``, ``keep_pad`` and the zero-tail contract)
works around Mosaic's layout rules and is not ported; the kernels take any T.
Not ported yet: dilated or pool-1 blocks 1+ (config #3) and the log-mel 2D
stack (config #4); both raise ``NotImplementedError``.

A qvars dict holds ``s0 (C0,)`` f32 and ``blocks``, one dict per block 1+
with ``w_q (3, Cin, Cout)`` int8 and ``alpha``, ``beta``, ``gamma`` ``(Cout,)``
f32, the JAX package's layout; ``save_qvars``/``load_qvars`` keep its
``.npz`` keys, so one artifact serves both packages.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.cuda_conv import bn_affine, conv_block0
from ..ops.cuda_quant_block import quant_block
from .convert import qvars_from_numpy
from .encoder import ConvBlock, ConvEncoder

# Smallest batch at which int8 serving beats bf16 on the H100. chip_smoke.py's
# timing phase (NVIDIA H100 80GB HBM3, 700 W) measured int8 faster at every
# batch of 1, 8, 64, 256 and 2048, store → embedding: 0.80 against 1.34 ms at
# B=1, where both are launch-bound and int8 launches fewer kernels (PERF.md §5).
# The TPU's 8 came from the v5e and does not carry over.
INT8_MIN_BATCH = 1


def int8_worthwhile(batch_size: int) -> bool:
    """Dtype-by-batch serving policy: True when int8 is expected to beat
    bf16 at this batch size (see INT8_MIN_BATCH)."""
    return batch_size >= INT8_MIN_BATCH


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
    ``cfg``: the full ExperimentConfig.
    """
    from ..train.steps import fetch_batch

    if cfg.mode == "melspec2d":
        raise NotImplementedError("int8 serving of the log-mel 2D encoder is not ported")
    n = min(n_cal, int(store.labels.shape[0]))
    idx = torch.arange(n, dtype=torch.int32, device=store.audio.device)
    x_cal = fetch_batch(store, idx, cfg, stochastic=False)
    return quantize_encoder(getattr(model, "encoder", model), x_cal)


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
    """
    cfg = encoder.cfg
    if qvars.get("kind") == "mel":
        raise NotImplementedError("int8 serving of the log-mel 2D encoder is not ported")
    n = len(encoder.blocks)
    if n < 2:
        raise ValueError("quantized path needs at least 2 conv blocks")
    if cfg.dilations[0] != 1:
        raise ValueError("quant_embed: the block-0 kernel takes dilation 1 only")
    for i in range(1, n):
        if (cfg.kernel_sizes[i], cfg.pool_sizes[i], cfg.dilations[i]) != (3, 2, 1):
            raise NotImplementedError(
                f"quant_embed: block {i} has k={cfg.kernel_sizes[i]}, pool="
                f"{cfg.pool_sizes[i]}, dilation={cfg.dilations[i]}; the int8 kernel "
                "takes k=3, pool 2, dilation 1 (dilated stacks are not ported)")
    cdt = encoder.compute_dtype
    blk = encoder.blocks[0]
    with torch.inference_mode():
        h_q = conv_block0(
            x, blk.conv.weight.permute(2, 1, 0), blk.conv.bias, blk.bn.weight,
            blk.bn.bias, blk.bn.running_mean, blk.bn.running_var, blk.bn.eps,
            pool=blk.pool_size, gemm_dtype=cdt, requant_scale=qvars["s0"])
        for i, qblk in enumerate(qvars["blocks"], start=1):
            h_q = quant_block(h_q, qblk["w_q"], qblk["alpha"], qblk["beta"], qblk["gamma"],
                              last=i == n - 1, out_dtype=cdt)
        return encoder.pool_and_embed(h_q.transpose(1, 2))
