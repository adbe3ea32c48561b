"""The embedding space of a subset in two dimensions, on the card.

Port of ``experiments/visualize_embeddings.py``: every option of the JAX
script with its name and default, and ``--device``. Embeds every utterance
of the subsets with a trained (or the seeded random-init) model, projects
the table onto its first two principal axes (an SVD in numpy), and writes
``<out>.npz`` (``embeddings``, ``labels``, ``pca2d``) and, where matplotlib
imports, a speaker-coloured scatter ``<out>.png``.

    python -m voicemap_tpu_torch.experiments.visualize_embeddings \\
        --data-root /tmp/syn --checkpoint-dir /tmp/ckpt --out /tmp/emb
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import config as C
from . import add_device_option, restore_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=["dev-clean"])
    p.add_argument("--mode", default="classifier",
                   choices=["classifier", "siamese", "melspec2d"])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--out", default="embeddings")
    p.add_argument("--max-store-seconds", type=float, default=30.0)
    add_device_option(p)
    return p.parse_args(argv)


def pca2d(table: np.ndarray) -> np.ndarray:
    """The rows of ``table`` on its first two principal axes (centred, SVD)."""
    centered = table - table.mean(axis=0, keepdims=True)
    _u, _s, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:2].T


def plot(proj: np.ndarray, labels: np.ndarray, speakers, subsets, out_png: str) -> bool:
    """The speaker-coloured scatter, where matplotlib imports → whether it
    was written (without matplotlib a line says so and nothing fails)."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {out_png} not written")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    uniq = np.unique(labels)
    plt.figure(figsize=(8, 7))
    cmap = plt.cm.tab20
    for s in uniq:
        pts = proj[labels == s]
        plt.scatter(pts[:, 0], pts[:, 1], s=14, color=cmap(int(s) % 20),
                    label=str(speakers[int(s)]) if len(uniq) <= 20 else None)
    if len(uniq) <= 20:
        plt.legend(title="speaker", fontsize=7, markerscale=1.2)
    plt.title(f"Utterance embeddings (PCA) — {', '.join(subsets)}")
    plt.tight_layout()
    plt.savefig(out_png, dpi=140)
    plt.close()
    return True


def main(argv=None):
    args = parse_args(argv)
    from ..data.dataset import dataset_from_config
    from ..eval import nshot
    from ..train import steps as steps_mod

    cfg = C.ExperimentConfig(
        mode=args.mode,
        data=C.DataConfig(data_root=args.data_root, subsets=tuple(args.subsets),
                          seconds=args.seconds, downsampling=args.downsampling,
                          stochastic=False),
        encoder=C.EncoderConfig(filters=args.filters, embedding_dim=args.embedding_dim),
    )
    ds = dataset_from_config(cfg.data)
    store = steps_mod.device_store_for(cfg, ds.to_store(args.max_store_seconds), args.device)
    model, step = restore_model(cfg, ds.num_classes(), args.checkpoint_dir, args.which,
                                args.device)
    if step is not None:
        print(f"restored step {step}")
    table = nshot.embed_all(model, store, cfg).cpu().numpy()
    labels = store.labels.cpu().numpy()
    proj = pca2d(table)
    np.savez(f"{args.out}.npz", embeddings=table, labels=labels, pca2d=proj)
    png = plot(proj, labels, ds.unique_speakers, args.subsets, f"{args.out}.png")
    print(f"wrote {args.out}.npz" + (f" and {args.out}.png" if png else "")
          + f" ({table.shape[0]} utterances, {len(ds.unique_speakers)} speakers)")
    return {"embeddings": table, "labels": labels, "pca2d": proj}


if __name__ == "__main__":
    main()
