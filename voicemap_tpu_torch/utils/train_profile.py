"""Where a train step's time goes, on one GPU.

    python3 -m voicemap_tpu_torch.utils.train_profile [--batches 32 2048] [--seed 0]

Config #1 at full width, initialised from ``--seed`` as ``fit`` does, trained
on a seeded synthetic store of 40 speakers × 8 utterances of 3.5–6 s, through
``make_classifier_train_step`` (B1, B4/B5, cuDNN convs, B7 under
``blockn="fused"``, the clipped Adam update). For each batch size and each
blocks-1+ policy (``jnp``, ``fused``):

1. the step's time on the host clock, each step waited for (median of 10),
   and on CUDA events over 10 back-to-back steps;
2. ``torch.profiler`` over 3 steps: device time by kernel name, device
   events a step, and the device's idle share (as ``stage_profile``).

Prints the card line, then one JSON line per (batch, policy). Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from ..config import classifier_baseline
from ..data.store import synthetic_store
from ..train import steps
from ..train.loop import init_model
from ..train.state import init_state
from .profiling import time_fn
from .stage_profile import profile


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[32, 2048])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    host = synthetic_store(args.seed, n_speakers=40, utterances_per_speaker=8,
                           min_seconds=3.5, max_seconds=6.0)
    base = classifier_baseline()
    store = steps.device_store_for(base, host, "cuda")
    for batch in args.batches:
        for blockn in ("jnp", "fused"):
            cfg = base.replace(train=dataclasses.replace(
                base.train, batch_size=batch, use_fused_blockn=blockn == "fused"))
            model = init_model(cfg, len(host.label_names), "cuda", args.seed)
            state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
            step, loss_fn = steps.make_classifier_train_step(model, cfg)
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            host_s = []
            for i in range(12):
                t0 = time.perf_counter()
                step(state, store, gen)
                torch.cuda.synchronize()
                if i >= 2:
                    host_s.append(time.perf_counter() - t0)
            events = time_fn(step, state, store, gen, iters=10, warmup=1)
            prof = profile([("step", lambda _: step(state, store, gen))])
            print(json.dumps({"batch": batch, "blockn": blockn,
                              "fused_block0": loss_fn.fused_block0,
                              "host_ms_median": statistics.median(host_s) * 1e3,
                              "events_ms_mean": events["mean_s"] * 1e3,
                              "events_ms_p50": events["p50_s"] * 1e3,
                              "profile": prof}), flush=True)
            del model, state, step, loss_fn
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
