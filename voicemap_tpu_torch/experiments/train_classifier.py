"""Train the softmax speaker classifier (config #1) on the card.

Port of ``experiments/train_classifier.py``: every option of the JAX script
with its name and default, and ``--device``. ``--synthetic`` writes a
LibriSpeech-shaped synthetic corpus under ``--data-root`` first;
``--dilated`` trains config #3's encoder, ``--melspec`` config #4's log-mel
classifier. Training is the port's ``fit(cfg)`` from the corpus on disk
(``--pipeline``); ``--profile`` writes a ``torch.profiler`` Chrome trace of
the run, with the program's ``voicemap.*`` spans on it. ``--quant-forward
int8`` trains blocks 1+ through the int8 forward (``fused_int8``),
``--pallas-preprocess off`` from the raw store through the plain
preprocessing chain. ``--dp on`` trains data-parallel over the
processes started with ``VOICEMAP_NUM_PROCESSES``, ``VOICEMAP_PROCESS_ID``
and ``VOICEMAP_COORDINATOR`` (``parallel/distributed.initialize``); in one
process it warns and trains unsharded.

    python -m voicemap_tpu_torch.experiments.train_classifier --synthetic \\
        --data-root /tmp/syn --num-steps 300 --checkpoint-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from .. import config as C
from . import add_device_option
from ._train import resolve_val_subsets, run_fit, train_flags, write_synthetic


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=["dev-clean"])
    p.add_argument("--val-subsets", nargs="+", default=None,
                   help="held-out eval subsets (the reference protocol gates on a "
                        "held-out subset, stochastic=False); default: test-clean "
                        "when available, else the training store with a warning; "
                        "'none' gates on the training store explicitly (warns)")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--label", default="speaker", choices=["speaker", "sex"])
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--dropout", type=float, default=0.05)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num-steps", type=int, default=2000)
    p.add_argument("--evaluate-every", type=int, default=500)
    p.add_argument("--num-eval-tasks", type=int, default=500)
    p.add_argument("--n-shot", type=int, default=1)
    p.add_argument("--k-way", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--quant-forward", default="none", choices=["none", "int8"],
                   help="blocks-1+ forward convs in int8 (s8 x s8 -> s32 on the B3 kernel's "
                        "train epilogue, a straight-through backward)")
    p.add_argument("--fused-block0", default="auto", choices=["auto", "on", "off"],
                   help="block 0 through the B4/B5 kernels; auto = on the card")
    p.add_argument("--pallas-preprocess", default="auto", choices=["auto", "on", "off"],
                   help="auto and on: gather and whiten through the B1 kernel from a "
                        "store decimated once; off: the raw store and the plain chain")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-path", default=None)
    p.add_argument("--dilated", action="store_true",
                   help="the deeper dilated conv stack (config #3)")
    p.add_argument("--melspec", action="store_true",
                   help="log-mel frontend + 2D-CNN embedder (config #4)")
    p.add_argument("--mel-geometry", default="librosa", choices=["librosa", "tpu"],
                   help="librosa = hop 160 / win 400; tpu = hop 128 / win 384")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic corpus under --data-root first")
    p.add_argument("--synthetic-speakers", type=int, default=20)
    p.add_argument("--synthetic-utterances", type=int, default=10)
    p.add_argument("--synthetic-container", default="wav", choices=["wav", "flac"])
    p.add_argument("--pipeline", default="auto", choices=["auto", "device", "streaming"],
                   help="device = the corpus in one store on the card; streaming = "
                        "host-cut batches from disk; auto picks by the store's size")
    p.add_argument("--dp", default="auto", choices=["auto", "on", "off"],
                   help="data-parallel training (on: not ported yet)")
    p.add_argument("--max-store-seconds", type=float, default=30.0)
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace of the run to this directory; "
                        "it carries the program's voicemap.* spans (a step's fetch_batch, forward, "
                        "backward and optimizer; embed_rows in each evaluation)")
    add_device_option(p)
    args = p.parse_args(argv)
    args.val_subsets = resolve_val_subsets(args, ["test-clean"])
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.synthetic:
        write_synthetic(args)
    if args.dilated:
        enc = dataclasses.replace(C.dilated_4khz().encoder, filters=args.filters,
                                  embedding_dim=args.embedding_dim, dropout=args.dropout,
                                  compute_dtype=args.compute_dtype)
    else:
        enc = C.EncoderConfig(filters=args.filters, embedding_dim=args.embedding_dim,
                              dropout=args.dropout, compute_dtype=args.compute_dtype)
    mode = "melspec2d" if args.melspec else "classifier"
    mel = (C.MelConfig(hop_length=128, win_length=384) if args.mel_geometry == "tpu"
           else C.MelConfig())
    cfg = C.ExperimentConfig(
        name=mode, mode=mode, mel=mel,
        data=C.DataConfig(data_root=args.data_root, subsets=tuple(args.subsets),
                          val_subsets=tuple(args.val_subsets) if args.val_subsets else None,
                          seconds=args.seconds,
                          downsampling=1 if args.melspec else args.downsampling,
                          label=args.label),
        encoder=enc,
        train=C.TrainConfig(**train_flags(args),
                            log_path=args.log_path
                            or os.path.join("logs", "classifier", "metrics.jsonl")),
    )
    print(f"experiment: {cfg.artifact_name()}")
    return run_fit(cfg, args)[1]


if __name__ == "__main__":
    main()
