"""Where an embed batch's device time goes, stage by stage, on one GPU.

    python3 -m voicemap_tpu_torch.utils.stage_profile [--batch 2048] [--seed 0]

Config #1 at full width with seeded random weights, over the store shape that
``chip_smoke.py`` and ``bench.py`` measure (rows of 3.5 s int16 at 16 kHz,
decimated by 4, 12000-sample fragments at random offsets), through the bf16
path (``fast_embed``) and the int8 path (``quant_embed``, calibrated on the
first 256 rows):

1. the CUDA-event time of each stage, median of 5 batches;
2. ``torch.profiler`` over 3 batches: device time by kernel name (the
   ``aten::`` op rows, which repeat their kernels' time, are left out), and
   the device's idle share (1 − union of kernel intervals / the window).

Prints the card line, then one JSON line per path. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..config import classifier_baseline
from ..models.classifier import SpeakerClassifier
from ..models.quant_infer import quantize_encoder
from ..ops.cuda_conv import conv_block0
from ..ops.cuda_preprocess import decimate_store, gather_whiten
from ..ops.cuda_quant_block import quant_block

STORE_T, DS, FRAG = 56000, 4, 12000


def stages_bf16(encoder, x_fn):
    """fast_embed, split at its stages: (name, fn of the previous output)."""
    blk0 = encoder.blocks[0]
    cdt = encoder.compute_dtype
    out = [("gather_whiten", lambda _: x_fn()),
           ("conv_block0", lambda x: conv_block0(
               x, blk0.conv.weight.permute(2, 1, 0), blk0.conv.bias, blk0.bn.weight,
               blk0.bn.bias, blk0.bn.running_mean, blk0.bn.running_var, blk0.bn.eps,
               out_dtype=cdt, gemm_dtype=cdt).transpose(1, 2))]
    for i, blk in enumerate(encoder.blocks[1:], start=1):
        # block 1 reads B2's (B, T, C) output through a channel-first view
        out.append((f"block_{i}", blk.forward_nct))
    out.append(("global_max_dense", encoder.pool_and_embed))
    return out


def stages_int8(encoder, qvars, x_fn):
    """quant_embed, split at its stages."""
    blk0 = encoder.blocks[0]
    cdt = encoder.compute_dtype
    out = [("gather_whiten", lambda _: x_fn()),
           ("conv_block0_int8", lambda x: conv_block0(
               x, blk0.conv.weight.permute(2, 1, 0), blk0.conv.bias, blk0.bn.weight,
               blk0.bn.bias, blk0.bn.running_mean, blk0.bn.running_var, blk0.bn.eps,
               gemm_dtype=cdt, requant_scale=qvars["s0"]))]
    n = len(qvars["blocks"])
    for i, q in enumerate(qvars["blocks"], start=1):
        out.append((f"quant_block_{i}", lambda h, q=q, last=i == n: quant_block(
            h, q["w_q"], q["alpha"], q["beta"], q["gamma"], last=last, out_dtype=cdt)))
    out.append(("global_max_dense", lambda h: encoder.pool_and_embed(h.transpose(1, 2))))
    return out


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


def profile(stages, batches: int = 3) -> dict:
    """Device time by kernel and the idle share over ``batches`` batches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    run(stages)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            run(stages)
        torch.cuda.synchronize()
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
            by_kernel[e.key[:80]] = t / 1e3 / batches
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15])
    return {"window_ms_per_batch": window / 1e3 / batches,
            "idle_share": 1.0 - busy / window, "device_events_per_batch": len(spans) / batches,
            "device_ms_by_op_per_batch": top}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    torch.manual_seed(args.seed)
    cfg = classifier_baseline()
    model = SpeakerClassifier(cfg.encoder, 40)
    rng = np.random.default_rng(args.seed)
    raw = rng.integers(-20000, 20000, size=(args.batch, STORE_T), dtype=np.int16)
    store = decimate_store(torch.from_numpy(raw).cuda(), DS)
    idx = torch.arange(args.batch, dtype=torch.int32, device="cuda")
    offsets = torch.from_numpy(
        rng.integers(0, store.shape[1] - FRAG + 1, args.batch).astype(np.int32)).cuda()

    def x_fn():
        return gather_whiten(store, idx, offsets, FRAG)[..., None]

    with torch.inference_mode():
        qvars = quantize_encoder(model.encoder, x_fn()[:256])
        for path, stages in (("bf16", stages_bf16(model.encoder, x_fn)),
                             ("int8", stages_int8(model.encoder, qvars, x_fn))):
            ms = stage_ms(stages)
            print(json.dumps({"path": path, "batch": args.batch, "stage_ms": ms,
                              "total_ms": sum(ms.values()), "profile": profile(stages)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
