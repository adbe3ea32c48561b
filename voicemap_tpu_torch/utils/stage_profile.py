"""Where an embed batch's device time goes, stage by stage, on one GPU.

    python3 -m voicemap_tpu_torch.utils.stage_profile [--batch 2048] [--seed 0]
        [--config classifier_baseline|dilated_4khz|melspec_2d ...]

Each config at full width with seeded random weights, over the store shape
that ``chip_smoke.py`` and ``bench.py`` measure (rows of 3.5 s int16 at
16 kHz, fragments at random offsets), through its bf16 path and its int8
path (calibrated on the first 256 rows):

- config #1: 12000-sample fragments of the store decimated by 4; bf16 is
  ``fast_embed`` (B1, B2, B8 × 3 for blocks 1–3, head), int8 ``quant_embed``
  (B1, B2 with requant, B3 × 3, head);
- config #3 (``dilated_4khz``): the same fragments; bf16 B1, B2, B8 × 7 for
  the dilated and pool-1 blocks 1–7, head; int8 B1, B2 with requant, B3 ×
  7, head;
- config #4: 48000-sample fragments at downsampling 1; bf16 is the
  ``MelSpecEncoder`` forward (B1, B6, standardize, cuDNN 2D blocks 0–3,
  head), int8 ``quant_embed_mel`` (B1, B6, standardize, quantize, int8
  patch-matrix blocks 0–3, head).

For each path:

1. the CUDA-event time of each stage, median of 5 batches;
2. ``torch.profiler`` over 3 batches: device time by kernel name (the
   ``aten::`` op rows, which repeat their kernels' time, are left out), and
   the device's idle share (1 − union of kernel intervals / the window).

Prints the card line, then one JSON line per path, with its peak memory.
``--config`` picks the configs (default: config #1 and config #4). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..config import classifier_baseline, dilated_4khz, melspec_2d
from ..models.classifier import SpeakerClassifier
from ..models.fast_infer import blockn
from ..models.quant_infer import mel_int8_stages, quantize_encoder, quantize_mel_encoder
from ..models.spectrogram import MelSpecClassifier
from ..ops.cuda_conv import conv_block0
from ..ops.cuda_preprocess import decimate_store, gather_whiten
from ..ops.cuda_quant_block import quant_block
from .profiling import clear_spans

STORE_T, DS, FRAG = 56000, 4, 12000
MEL_FRAG = 48000  # config #4: 3 s at downsampling 1
CONFIGS = {"classifier_baseline": classifier_baseline, "dilated_4khz": dilated_4khz,
           "melspec_2d": melspec_2d}


def stages_bf16(encoder, x_fn):
    """fast_embed, split at its stages: (name, fn of the previous output)."""
    blk0 = encoder.blocks[0]
    cdt = encoder.compute_dtype
    out = [("gather_whiten", lambda _: x_fn()),
           ("conv_block0", lambda x: conv_block0(
               x, blk0.conv.weight.permute(2, 1, 0), blk0.conv.bias, blk0.bn.weight,
               blk0.bn.bias, blk0.bn.running_mean, blk0.bn.running_var, blk0.bn.eps,
               out_dtype=cdt, gemm_dtype=cdt))]
    for i, blk in enumerate(encoder.blocks[1:], start=1):
        # channels last: B8 where it takes the block, else cuDNN
        out.append((f"block_{i}", lambda h, blk=blk: blockn(blk, h)))
    out.append(("global_max_dense", lambda h: encoder.pool_and_embed(h.transpose(1, 2))))
    return out


def stages_int8(encoder, qvars, x_fn):
    """quant_embed, split at its stages."""
    blk0 = encoder.blocks[0]
    cdt = encoder.compute_dtype
    pools, dilations = encoder.cfg.pool_sizes, encoder.cfg.dilations
    out = [("gather_whiten", lambda _: x_fn()),
           ("conv_block0_int8", lambda x: conv_block0(
               x, blk0.conv.weight.permute(2, 1, 0), blk0.conv.bias, blk0.bn.weight,
               blk0.bn.bias, blk0.bn.running_mean, blk0.bn.running_var, blk0.bn.eps,
               gemm_dtype=cdt, requant_scale=qvars["s0"]))]
    n = len(qvars["blocks"])
    for i, q in enumerate(qvars["blocks"], start=1):
        out.append((f"quant_block_{i}", lambda h, q=q, last=i == n, i=i: quant_block(
            h, q["w_q"], q["alpha"], q["beta"], q["gamma"], last=last, out_dtype=cdt,
            pool=max(pools[i], 1), dilation=dilations[i])))
    out.append(("global_max_dense", lambda h: encoder.pool_and_embed(h.transpose(1, 2))))
    return out


def stages_mel_bf16(encoder, x_fn):
    """The MelSpecEncoder forward's own stages, after the gather."""
    return [("gather_whiten", lambda _: x_fn())] + encoder.stages()


def stages_mel_int8(encoder, qvars, x_fn):
    """quant_embed_mel's own stages, after the gather."""
    return [("gather_whiten", lambda _: x_fn())] + mel_int8_stages(encoder, qvars)


def run(stages):
    h = None
    for _, fn in stages:
        h = fn(h)
    return h


def stage_ms(stages, repeats: int = 5) -> dict:
    """Median CUDA-event milliseconds of each stage over ``repeats`` batches."""
    run(stages)  # warm-up
    times = {name: [] for name, _ in stages}
    for _ in range(repeats):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        h = None
        events[0].record()
        for (name, fn), end in zip(stages, events[1:]):
            h = fn(h)
            end.record()
        torch.cuda.synchronize()
        for (name, _), a, b in zip(stages, events, events[1:]):
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(v) for name, v in times.items()}


# cuDNN's kernels that convert a tensor between NCHW and NHWC around a conv
# (nchwToNhwcKernel, nhwcToNchwKernel and their kin).
LAYOUT_CONVERSION = re.compile(r"nchw_?2_?nhwc|nhwc_?2_?nchw|nchwtonhwc|nhwctonchw", re.I)


def profile(stages, batches: int = 3) -> dict:
    """Device time by kernel, the idle share and the device ms of layout
    conversions (:data:`LAYOUT_CONVERSION`) over ``batches`` batches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    run(stages)
    torch.cuda.synchronize()
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(batches):
                run(stages)
            torch.cuda.synchronize()
    finally:
        clear_spans()  # the stages' spans have no reader here
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"error": "the profiler recorded no device events"}
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0 and not e.key.startswith("aten::"):
            by_kernel[e.key] = t / 1e3 / batches
    short = {}  # names cut to 80 characters; kernels that share a cut name are summed
    for k, v in by_kernel.items():
        short[k[:80]] = short.get(k[:80], 0.0) + v
    conversions = {k: v for k, v in short.items() if LAYOUT_CONVERSION.search(k)}
    top = dict(sorted(short.items(), key=lambda kv: -kv[1])[:15])
    return {"window_ms_per_batch": window / 1e3 / batches,
            "idle_share": 1.0 - busy / window, "device_events_per_batch": len(spans) / batches,
            "layout_conversion_ms_per_batch": sum(conversions.values()),
            "layout_conversion_kernels": conversions,
            "device_ms_by_op_per_batch": top}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--config", nargs="+", choices=sorted(CONFIGS),
                        default=["classifier_baseline", "melspec_2d"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    for name in args.config:
        cfg = CONFIGS[name]()
        mel = cfg.mode == "melspec2d"
        torch.manual_seed(args.seed)
        rng = np.random.default_rng(args.seed)
        raw = torch.from_numpy(
            rng.integers(-20000, 20000, size=(args.batch, STORE_T), dtype=np.int16)).cuda()
        idx = torch.arange(args.batch, dtype=torch.int32, device="cuda")
        store, frag = (raw, MEL_FRAG) if mel else (decimate_store(raw, DS), FRAG)
        offsets = torch.from_numpy(
            rng.integers(0, store.shape[1] - frag + 1, args.batch).astype(np.int32)).cuda()

        def x_fn(store=store, offsets=offsets, frag=frag):
            return gather_whiten(store, idx, offsets, frag)[..., None]

        with torch.inference_mode():
            if not mel:
                enc = SpeakerClassifier(cfg.encoder, 40).encoder
                qvars = quantize_encoder(enc, x_fn()[:256])
                paths = (("bf16", stages_bf16(enc, x_fn)),
                         ("int8", stages_int8(enc, qvars, x_fn)))
            else:
                enc = MelSpecClassifier(cfg.encoder, cfg.mel, 40, cfg.data.sample_rate).encoder
                qvars = quantize_mel_encoder(enc, x_fn()[:256])
                paths = (("bf16", stages_mel_bf16(enc, x_fn)),
                         ("int8", stages_mel_int8(enc, qvars, x_fn)))
            for path, stages in paths:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                ms = stage_ms(stages)
                peak = torch.cuda.max_memory_allocated() / 1e9
                print(json.dumps({"config": cfg.name, "path": path, "batch": args.batch,
                                  "stage_ms": ms, "total_ms": sum(ms.values()),
                                  "peak_mem_gb": peak, "profile": profile(stages)}),
                      flush=True)
        del raw, store, enc, qvars, paths
    return 0


if __name__ == "__main__":
    sys.exit(main())
