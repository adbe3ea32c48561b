"""n-shot k-way speaker identification, and the frozen protocol, on the card.

Port of ``experiments/evaluate.py``: every option of the JAX script with its
name and default, and ``--device``. Restore a checkpoint (or evaluate the
seeded random init), embed the subset once, score every task at once, and
report the accuracy with its Monte-Carlo standard error. The tasks come
from ``jax_random.PRNGKey(--seed)`` (the JAX script's tasks for the same
seed), the verification pairs from ``PRNGKey(--seed + 1)``.

- ``--fast``: embed through B2 → B8; ``--int8`` (or ``--qvars``): through
  the int8 serving path, B2 requantizing → B3;
- ``--k-sweep KMIN KMAX``: accuracy against k from one table, written to
  ``<sweep-out>.json`` (and ``.png`` where matplotlib imports);
- ``--verification N``: EER and AUC over N balanced pairs;
- ``--protocol``: the ``EVAL_PROTOCOL.json`` entries, one JSON record each;
  ``--int8-gate`` with it: the int8 decision gate's verdict, exit 2 on fail.

    python -m voicemap_tpu_torch.experiments.evaluate --data-root /tmp/syn \\
        --checkpoint-dir /tmp/ckpt --protocol --allow-corpus-mismatch
"""

from __future__ import annotations

import argparse
import json
import math

from .. import config as C
from . import add_device_option, restore_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=["dev-clean"])
    p.add_argument("--mode", default="classifier",
                   choices=["classifier", "siamese", "melspec2d"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="restore the best (or latest) state from this directory")
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--distance-metric", default="uniform_euclidean")
    p.add_argument("--num-tasks", type=int, default=500)
    p.add_argument("--n-shot", type=int, default=1)
    p.add_argument("--k-way", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--max-store-seconds", type=float, default=30.0)
    p.add_argument("--fast", action="store_true",
                   help="embed through the B2 and B8 kernels (block 0, blocks 1+)")
    p.add_argument("--int8", action="store_true",
                   help="embed through the int8 serving path, calibrated on the "
                        "eval store (melspec2d: the conv2d stack in int8)")
    p.add_argument("--qvars", default=None, metavar="PATH",
                   help="load a saved int8 artifact (embed --save-qvars) instead of "
                        "calibrating (implies --int8; ad-hoc path only, not --protocol)")
    p.add_argument("--k-sweep", type=int, nargs=2, default=None, metavar=("KMIN", "KMAX"),
                   help="sweep k-way over [KMIN, KMAX] from ONE embedding table; writes "
                        "<sweep-out>.json (+ .png) and prints one JSON line a point")
    p.add_argument("--sweep-n-shots", type=int, nargs="+", default=[1, 5],
                   help="n-shot curves to draw in the k sweep")
    p.add_argument("--sweep-out", default="accuracy_vs_k",
                   help="artifact path prefix for --k-sweep")
    p.add_argument("--verification", type=int, default=None, metavar="N",
                   help="also report EER and AUC over N balanced same/different pairs")
    p.add_argument("--protocol", action="store_true",
                   help="run the frozen EVAL_PROTOCOL.json manifest (pinned seeds, "
                        "subsets, fragments; corpus-identity check; JSON output)")
    p.add_argument("--allow-corpus-mismatch", action="store_true",
                   help="with --protocol: run on a corpus that fails the identity "
                        "check; the records are marked non-comparable")
    p.add_argument("--int8-gate", action="store_true",
                   help="with --protocol: every entry in full precision and in int8, "
                        "z-test of each metric; prints {int8_accuracy_gate: pass|fail} "
                        "and exits 2 on fail")
    add_device_option(p)
    return p.parse_args(argv)


# Fixed-order categorical hues (CVD-safe on the light surface), one an
# n-shot curve; chance is a neutral dashed line.
_SERIES_COLORS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]


def plot_sweep(results, out_png, subsets) -> bool:
    """The accuracy-against-k figure, where matplotlib imports → whether it
    was written (without matplotlib a line says so and nothing fails)."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {out_png} not written")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    by_n = {}
    for r in results:
        if "accuracy" in r:
            by_n.setdefault(r["n_shot"], []).append(r)
    fig, ax = plt.subplots(figsize=(7, 4.5), dpi=150)
    fig.patch.set_facecolor("#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    ks_all = sorted({r["k_way"] for r in results})
    ax.plot(ks_all, [1.0 / k for k in ks_all], ls="--", lw=1.5, color="#52514e",
            label="chance (1/k)")
    for i, (n, pts) in enumerate(sorted(by_n.items())):
        pts = sorted(pts, key=lambda r: r["k_way"])
        ks = [r["k_way"] for r in pts]
        acc = [r["accuracy"] for r in pts]
        se = [r["stderr"] for r in pts]
        c = _SERIES_COLORS[i % len(_SERIES_COLORS)]
        ax.plot(ks, acc, lw=2, color=c, marker="o", ms=4, label=f"{n}-shot")
        ax.fill_between(ks, [a - 1.96 * s for a, s in zip(acc, se)],
                        [a + 1.96 * s for a, s in zip(acc, se)], color=c, alpha=0.15, lw=0)
    ax.set_xlabel("k-way (speakers per task)", color="#0b0b0b")
    ax.set_ylabel("accuracy", color="#0b0b0b")
    ax.set_title(f"n-shot speaker ID accuracy vs k — {', '.join(subsets)}",
                 color="#0b0b0b", fontsize=11)
    ax.set_ylim(0.0, 1.02)
    ax.xaxis.set_major_locator(MaxNLocator(integer=True))
    ax.grid(True, color="#e6e5e1", lw=0.6)
    for spine in ax.spines.values():
        spine.set_color("#c3c2b7")
    ax.tick_params(colors="#52514e")
    ax.legend(frameon=False, loc="lower left")
    fig.tight_layout()
    fig.savefig(out_png, facecolor=fig.get_facecolor())
    plt.close(fig)
    return True


def _refuse(args) -> None:
    """The JAX script's refusals of option sets it does not run."""
    if args.qvars and args.protocol:
        raise SystemExit("--qvars is for the ad-hoc path; --protocol --int8 calibrates "
                         "per manifest entry on that entry's store")
    if args.int8_gate and not args.protocol:
        raise SystemExit("--int8-gate requires --protocol (the gate is a statement "
                         "about the frozen manifest entries)")
    if args.protocol and args.k_sweep:
        raise SystemExit("--protocol runs the manifest's pinned (n, k) entries; "
                         "--k-sweep is the ad-hoc path — drop one of the two")
    if args.k_sweep and not 2 <= args.k_sweep[0] <= args.k_sweep[1]:
        raise SystemExit("--k-sweep needs 2 <= KMIN <= KMAX")


def run_protocol(model, cfg, args):
    """``--protocol``: the records (printed one a line), or with
    ``--int8-gate`` the verdict (printed; SystemExit(2) on fail)."""
    from ..eval import protocol

    kw = dict(allow_corpus_mismatch=args.allow_corpus_mismatch,
              max_store_seconds=args.max_store_seconds, fast=args.fast)
    if args.int8_gate:
        verdict = protocol.int8_accuracy_gate(model, args.data_root, cfg, **kw)
        print(json.dumps(verdict))
        if verdict["int8_accuracy_gate"] != "pass":
            raise SystemExit(2)
        return verdict
    # One cache for both passes: decode, stores, calibration and tables.
    store_cache: dict = {}
    results = protocol.run_protocol(model, args.data_root, cfg, int8=args.int8,
                                    store_cache=store_cache, **kw)
    results += protocol.run_verification_protocol(model, args.data_root, cfg, int8=args.int8,
                                                  store_cache=store_cache, **kw)
    for r in results:
        print(json.dumps(r))
    return results


def main(argv=None):
    args = parse_args(argv)
    _refuse(args)
    from ..data.dataset import dataset_from_config
    from ..eval import nshot
    from ..ops import jax_random
    from ..train import steps as steps_mod

    cfg = C.ExperimentConfig(
        mode=args.mode,
        data=C.DataConfig(data_root=args.data_root, subsets=tuple(args.subsets),
                          seconds=args.seconds, downsampling=args.downsampling,
                          stochastic=False),
        encoder=C.EncoderConfig(filters=args.filters, embedding_dim=args.embedding_dim,
                                compute_dtype=args.compute_dtype),
        siamese=C.SiameseConfig(distance_metric=args.distance_metric),
        train=C.TrainConfig(num_eval_tasks=args.num_tasks, n_shot=args.n_shot,
                            k_way=args.k_way),
    )
    ds = dataset_from_config(cfg.data)  # the index only: no decode yet
    model, step = restore_model(cfg, ds.num_classes(), args.checkpoint_dir, args.which,
                                args.device)
    if args.checkpoint_dir and step is None:
        raise SystemExit(f"no {args.which} checkpoint under {args.checkpoint_dir}")
    if step is None:
        print("WARNING: evaluating an untrained (random-init) model")
    else:
        print(f"restored {args.which} checkpoint at step {step}")

    if args.protocol:
        return run_protocol(model, cfg, args)

    # The ad-hoc path decodes and ships its own store (the protocol builds
    # one an entry with the manifest's fragment settings).
    store = steps_mod.device_store_for(cfg, ds.to_store(args.max_store_seconds), args.device)
    qvars = None
    if args.qvars:
        from ..models.quant_infer import load_qvars

        qvars = load_qvars(args.qvars, device=args.device)
        print(f"int8 serving path: loaded artifact {args.qvars}")
    elif args.int8:
        from ..models.quant_infer import quantize_from_store

        qvars = quantize_from_store(model, cfg, store)
        print("int8 serving path: calibrated on the eval store")
    out = {}
    if args.k_sweep:
        kmin, kmax = args.k_sweep
        results = nshot.evaluate_sweep(
            model, store, cfg, jax_random.PRNGKey(args.seed), n_shots=args.sweep_n_shots,
            k_values=range(kmin, kmax + 1), num_tasks=args.num_tasks, fast=args.fast,
            qvars=qvars)
        for r in results:
            print(json.dumps(r))
        meta = {"subsets": args.subsets, "mode": args.mode,
                "checkpoint_dir": args.checkpoint_dir, "num_tasks": args.num_tasks,
                "seed": args.seed, "int8": bool(qvars is not None), "points": results}
        with open(args.sweep_out + ".json", "w") as f:
            json.dump(meta, f, indent=1)
        png = plot_sweep(results, args.sweep_out + ".png", args.subsets)
        print(f"wrote {args.sweep_out}.json" + (f" and {args.sweep_out}.png" if png else ""))
        out["sweep"] = results
    else:
        acc = nshot.evaluate(model, store, cfg, jax_random.PRNGKey(args.seed),
                             num_tasks=args.num_tasks, n=args.n_shot, k=args.k_way,
                             fast=args.fast, qvars=qvars)
        stderr = math.sqrt(max(acc * (1 - acc), 1e-12) / args.num_tasks)
        print(f"{args.n_shot}-shot {args.k_way}-way accuracy over {args.num_tasks} tasks "
              f"on {args.subsets}: {acc:.4f} ± {stderr:.4f} (1σ)")
        out["accuracy"], out["stderr"] = acc, stderr
    # --verification composes with both paths (it embeds its own table).
    if args.verification:
        from ..eval.verification import evaluate_verification

        v = evaluate_verification(model, store, cfg, jax_random.PRNGKey(args.seed + 1),
                                  num_pairs=args.verification, fast=args.fast, qvars=qvars)
        print(f"verification over {v['num_pairs']} pairs: EER {v['eer']:.4f} "
              f"(threshold {v['eer_threshold']:.4f}), AUC {v['auc']:.4f}")
        out["verification"] = v
    return out


if __name__ == "__main__":
    main()
