"""Train the siamese verification network (config #2) on the card.

Port of ``experiments/train_siamese.py``: every option of the JAX script
with its name and default, and ``--device``. Pairs of same and different
speakers, BCE (or the contrastive loss), the periodic n-shot evaluation
gating the checkpoints and the plateau schedule; training is the port's
``fit(cfg)`` from the corpus on disk. ``--distance-metric weighted_l1``
scores through the B9 kernel; ``--quant-forward int8`` and
``--pallas-preprocess off`` as in ``train_classifier``.

    python -m voicemap_tpu_torch.experiments.train_siamese --data-root /tmp/syn \\
        --subsets train-clean-100 --val-subsets dev-clean --distance-metric weighted_l1
"""

from __future__ import annotations

import argparse
import os

from .. import config as C
from . import add_device_option
from ._train import resolve_val_subsets, run_fit, train_flags, write_synthetic


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=["train-clean-100"])
    p.add_argument("--val-subsets", nargs="+", default=None,
                   help="held-out eval subsets (the reference protocol: dev-clean, "
                        "stochastic=False); default: dev-clean when available, else "
                        "the training store with a warning; 'none' gates on the "
                        "training store explicitly (warns)")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--distance-metric", default="uniform_euclidean",
                   choices=["uniform_euclidean", "weighted_l1", "uniform_l1",
                            "dot_product", "cosine_distance"])
    p.add_argument("--loss", default="bce", choices=["bce", "contrastive"])
    p.add_argument("--contrastive-margin", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num-steps", type=int, default=5000)
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
    p.add_argument("--synthetic", action="store_true")
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
                        "it carries the program's voicemap.* spans (a step's fetch_batch, backward "
                        "and optimizer; embed_rows in each evaluation)")
    add_device_option(p)
    args = p.parse_args(argv)
    args.val_subsets = resolve_val_subsets(args, ["dev-clean"])
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.synthetic:
        write_synthetic(args)
    cfg = C.ExperimentConfig(
        name="siamese", mode="siamese",
        data=C.DataConfig(data_root=args.data_root, subsets=tuple(args.subsets),
                          val_subsets=tuple(args.val_subsets) if args.val_subsets else None,
                          seconds=args.seconds, downsampling=args.downsampling),
        encoder=C.EncoderConfig(filters=args.filters, embedding_dim=args.embedding_dim,
                                dropout=args.dropout, compute_dtype=args.compute_dtype),
        siamese=C.SiameseConfig(distance_metric=args.distance_metric),
        train=C.TrainConfig(**train_flags(args), loss=args.loss,
                            contrastive_margin=args.contrastive_margin,
                            log_path=args.log_path
                            or os.path.join("logs", "siamese", "metrics.jsonl")),
    )
    print(f"experiment: {cfg.artifact_name()}")
    return run_fit(cfg, args)[1]


if __name__ == "__main__":
    main()
