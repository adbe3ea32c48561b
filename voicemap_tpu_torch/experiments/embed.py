"""Embed audio files, or whole subsets, to an ``.npz`` on the card.

Port of ``experiments/embed.py``: every option of the JAX script with its
name and default, and ``--device``. Writes ``embeddings`` (N, D) float32
and ``paths``. Explicit files become an in-memory store; ``--subsets`` are
read from the index and embedded from one store on the card
(``--pipeline device``) or streamed from disk (``streaming``: no B1; auto
picks by the store's size). ``--int8`` serves through the int8 path
(calibrated on the first batch); ``--save-qvars`` writes that calibration,
``--qvars`` serves from a saved one. ``--mode ecapa_tdnn``, the port's own,
embeds through ECAPA-TDNN at its preset's widths and front end (16 kHz,
undecimated): ``--filters``, ``--embedding-dim`` and ``--downsampling``
do not apply to it, nor does the int8 path.

    python -m voicemap_tpu_torch.experiments.embed --data-root /tmp/syn \\
        --subsets dev-clean --checkpoint-dir /tmp/ckpt --int8 --out emb.npz
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from .. import config as C
from . import add_device_option, restore_model

PORT_MODES = ("ecapa_tdnn",)  # modes of the port's own, which the JAX script lacks


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("files", nargs="*", help="audio files (.wav/.flac); or use --subsets")
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=None,
                   help="embed every utterance of these indexed subsets instead of files")
    p.add_argument("--mode", default="classifier",
                   choices=["classifier", "siamese", "melspec2d", *PORT_MODES])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--out", default="embeddings.npz")
    p.add_argument("--max-store-seconds", type=float, default=30.0)
    p.add_argument("--pipeline", default="auto", choices=["auto", "device", "streaming"],
                   help="device = ship the corpus to the card once; streaming = "
                        "corpus-order batches decoded on the host; auto picks by "
                        "the store's size")
    p.add_argument("--int8", action="store_true",
                   help="serve through the int8 path (calibrated on the first batch)")
    p.add_argument("--save-qvars", default=None, metavar="PATH",
                   help="write the int8 calibration (.npz) for calibration-free "
                        "serving (implies --int8)")
    p.add_argument("--qvars", default=None, metavar="PATH",
                   help="serve from a saved int8 calibration (implies --int8)")
    add_device_option(p)
    return p.parse_args(argv)


def _store_from_files(paths, cfg):
    """An in-memory ``AudioStore`` of explicit audio files, each zero-padded
    to the fragment, one speaker holding them all."""
    from ..data import audio
    from ..data.store import AudioStore

    frag = cfg.data.fragment_length
    waves = []
    for p in paths:
        data, sr = audio.read(p)
        if sr != cfg.data.sample_rate:
            raise SystemExit(f"{p}: sample rate {sr} != configured {cfg.data.sample_rate}")
        if data.shape[0] < frag:
            data = np.pad(data, (0, frag - data.shape[0]))
        waves.append(data)
    n = len(waves)
    audio_arr = np.zeros((n, max(w.shape[0] for w in waves)), np.int16)
    lengths = np.empty((n,), np.int32)
    for i, w in enumerate(waves):
        audio_arr[i, : w.shape[0]] = w
        lengths[i] = w.shape[0]
    return AudioStore(audio=audio_arr, lengths=lengths, labels=np.zeros((n,), np.int32),
                      speaker_utts=np.arange(n, dtype=np.int32)[None, :],
                      speaker_counts=np.asarray([n], np.int32),
                      sample_rate=cfg.data.sample_rate, label_names=[0])


def main(argv=None):
    args = parse_args(argv)
    if not args.files and not args.subsets:
        raise SystemExit("give audio files or --subsets")
    from ..eval import nshot
    from ..models import quant_infer
    from ..train import steps as steps_mod

    data = C.DataConfig(data_root=args.data_root, subsets=tuple(args.subsets or ("dev-clean",)),
                        seconds=args.seconds,
                        downsampling=1 if args.mode == "melspec2d" else args.downsampling,
                        stochastic=False)
    if args.mode == "ecapa_tdnn":
        if args.int8 or args.qvars or args.save_qvars:
            raise SystemExit("--mode ecapa_tdnn has no int8 path")
        preset = C.ecapa_tdnn()
        cfg = preset.replace(
            data=dataclasses.replace(preset.data, data_root=data.data_root,
                                     subsets=data.subsets, seconds=args.seconds,
                                     stochastic=False),
            ecapa=dataclasses.replace(preset.ecapa, compute_dtype=args.compute_dtype))
    else:
        cfg = C.ExperimentConfig(
            mode=args.mode, data=data,
            encoder=C.EncoderConfig(filters=args.filters, embedding_dim=args.embedding_dim,
                                    compute_dtype=args.compute_dtype))
    ds = None
    if args.subsets:
        from ..data.dataset import (dataset_from_config, estimate_store_bytes,
                                    streaming_threshold_bytes)

        ds = dataset_from_config(cfg.data)  # the index only: the decode follows the pipeline
        paths = [ds.path_of(int(i)) for i in ds.index.id]
        num_classes = ds.num_classes()
        pipeline = args.pipeline
        if pipeline == "auto":
            est = estimate_store_bytes(ds, args.max_store_seconds, cfg.data.sample_rate)
            pipeline = ("streaming" if est > streaming_threshold_bytes(args.device)
                        else "device")
            if pipeline == "streaming":
                print(f"pipeline=auto → streaming (est. store {est / 1e9:.2f} GB)")
    else:
        if args.pipeline == "streaming":
            raise SystemExit("--pipeline streaming needs --subsets (explicit files build "
                             "an in-memory store and always embed device-resident)")
        pipeline = "device"
        paths = list(args.files)
        num_classes = 2  # the head's width does not reach the embeddings

    store = None
    if pipeline == "device":
        host = (ds.to_store(args.max_store_seconds) if ds is not None
                else _store_from_files(args.files, cfg))
        store = steps_mod.device_store_for(cfg, host, args.device)

    model, step = restore_model(cfg, num_classes, args.checkpoint_dir, args.which,
                                args.device)
    if args.checkpoint_dir and step is None:
        raise SystemExit(f"no {args.which} checkpoint under {args.checkpoint_dir}")
    if step is None:
        print("WARNING: embedding with an untrained (random-init) model")
    else:
        print(f"restored {args.which} checkpoint at step {step}")

    qvars = None
    if args.int8 or args.qvars or args.save_qvars:
        if args.qvars:
            qvars = quant_infer.load_qvars(args.qvars, device=args.device)
            print(f"int8 serving path: loaded artifact {args.qvars}")
        elif store is not None:
            qvars = quant_infer.quantize_from_store(model, cfg, store, n_cal=args.batch_size)
            print("int8 serving path: calibrated on the first "
                  f"{min(args.batch_size, int(store.labels.shape[0]))} utterances")
        else:  # streaming: calibrate on the first corpus-order batch
            from ..data.pipeline import iter_embed_batches

            batches = iter_embed_batches(ds, cfg, args.batch_size)
            frags, count = next(batches)
            batches.close()
            qvars = quant_infer.quantize_from_frags(model, cfg, frags[:count])
            print(f"int8 serving path: calibrated on the first {count} utterances (streamed)")
        if args.save_qvars:
            quant_infer.save_qvars(args.save_qvars, qvars)
            print(f"wrote int8 artifact {args.save_qvars}")

    if store is not None:
        table = nshot.embed_all(model, store, cfg, batch_size=args.batch_size, qvars=qvars)
    else:
        table = nshot.embed_all_streaming(model, cfg, ds, batch_size=args.batch_size,
                                          qvars=qvars)
    table = table.cpu().numpy()
    np.savez(args.out, embeddings=table, paths=np.asarray(paths))
    print(f"wrote {args.out}: embeddings {table.shape}, {len(paths)} files")
    return table, paths


if __name__ == "__main__":
    main()
