"""The training loop: steps → periodic n-shot eval → plateau LR → checkpoints
→ JSONL metrics.

Port of ``voicemap_tpu/train/loop.py :: fit``, in classifier mode (configs
#1 and #3), siamese mode (config #2, BCE or contrastive) and log-mel mode
(config #4). ``fit`` trains either on an ``AudioStore`` that the caller
builds (``data/store.py``, for example ``synthetic_store``), or, with no
store given, on the corpus on disk that ``cfg.data`` names, as the JAX
``fit`` does: through the device pipeline (the corpus decoded into one
store on the card) or the streaming pipeline (``data/pipeline.py``, batches
cut on the host), picked by the store's size. With more than one process in
the default group, ``dp`` trains data-parallel by the JAX package's rules
(:func:`use_data_parallel`): the step builders of ``train/steps.py`` given
the ``data`` axis's process group (``parallel/data_parallel``). The train
forward is the one ``train/steps.resolve_blockn`` picks, ``fused_int8``
for ``quant_forward="int8"``; the store is decimated once for B1 or kept
raw for the plain chain as ``use_pallas_preprocess`` resolves
(``train/steps.device_store_for``).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..config import ExperimentConfig
from ..data import dataset as dataset_mod
from ..data.store import AudioStore
from ..eval import nshot
from ..models.classifier import SpeakerClassifier
from ..models.ecapa import EcapaClassifier
from ..models.siamese import SiameseNet
from ..models.spectrogram import MelSpecClassifier
from ..parallel import distributed, mesh as mesh_mod
from . import steps as steps_mod
from .checkpoints import CheckpointManager
from .metrics import JSONLWriter, PlateauScheduler
from .state import TrainState, init_state

_LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def init_model(cfg: ExperimentConfig, num_classes: int, device,
               seed: int) -> SpeakerClassifier | SiameseNet | MelSpecClassifier | EcapaClassifier:
    """The model of ``cfg.mode`` (a classifier of ``num_classes``; for
    ``"siamese"`` the siamese net, whose Dense(1) head ignores
    ``num_classes``; for ``"melspec2d"`` the log-mel classifier; for
    ``"ecapa_tdnn"`` ECAPA-TDNN with its cosine head) initialised
    as flax initialises it, from ``seed``: conv (1D and 2D) and Dense kernels
    lecun-normal (truncated at two standard deviations, fan-in k·Cin, 9·Cin
    for a 3×3 conv), biases zero, BatchNorm scale 1, bias 0, running mean 0,
    variance 1."""
    if cfg.mode == "siamese":
        model = SiameseNet(cfg.encoder, cfg.siamese, device=device)
    elif cfg.mode == "melspec2d":
        model = MelSpecClassifier(cfg.encoder, cfg.mel, num_classes, cfg.data.sample_rate,
                                  device=device)
    elif cfg.mode == "ecapa_tdnn":
        model = EcapaClassifier(cfg.ecapa, cfg.mel, num_classes, cfg.data.sample_rate,
                                device=device)
    else:
        model = SpeakerClassifier(cfg.encoder, num_classes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                std = mod.weight[0].numel() ** -0.5 / _LECUN_TRUNC
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


_HOLDOUT_MSG = ("n-shot eval (best-model gating + LR plateau) runs on the TRAINING "
                "store, which overstates accuracy")


def _no_holdout(t, what: str) -> None:
    msg = f"{what} — {_HOLDOUT_MSG}"
    if t.require_holdout_eval:
        raise ValueError(msg)
    warnings.warn(msg, UserWarning, stacklevel=3)


def _corpus_stores(cfg: ExperimentConfig, device, max_store_seconds, pipeline: str,
                   threshold, verbose: bool):
    """The corpus on disk that ``cfg.data`` names → ``(dataset, pipeline,
    train store or None, validation store)``, as the JAX ``fit`` builds them."""
    train_ds = dataset_mod.dataset_from_config(cfg.data)
    if pipeline == "auto":
        est = dataset_mod.estimate_store_bytes(train_ds, max_store_seconds,
                                               cfg.data.sample_rate)
        limit = threshold if threshold is not None else \
            dataset_mod.streaming_threshold_bytes(device)
        pipeline = "streaming" if est > limit else "device"
        if verbose:
            print(f"pipeline=auto → {pipeline} (est. store {est / 1e9:.2f} GB, "
                  f"threshold {limit / 1e9:.2f} GB)")
    store = None
    if pipeline == "device":
        store = steps_mod.device_store_for(cfg, train_ds.to_store(max_store_seconds), device)
    if cfg.data.val_subsets:
        val_cfg = dataclasses.replace(cfg.data, subsets=cfg.data.val_subsets, stochastic=False)
        val_ds = dataset_mod.dataset_from_config(val_cfg)
        val = steps_mod.device_store_for(cfg, val_ds.to_store(max_store_seconds), device)
    else:
        _no_holdout(cfg.train, "no val_subsets configured; set DataConfig.val_subsets for "
                    "the reference's held-out protocol (dev-clean, stochastic=False)")
        # Streaming without a val split: evaluate on a bounded sub-store.
        val = store if store is not None else steps_mod.device_store_for(
            cfg, train_ds.to_store(min(max_store_seconds or 30.0, 10.0)), device)
    return train_ds, pipeline, store, val


_DP_ONE_DEVICE_MSG = "dp='on' with a single attached device — training proceeds unsharded"


def use_data_parallel(dp: str, world: int, batch_size: int, device) -> bool:
    """Whether ``fit`` trains data-parallel over ``world`` ranks, by the JAX
    ``fit``'s rules: ``"on"`` whenever there is more than one rank (and it
    raises where the batch does not divide them), ``"auto"`` only with more
    than one rank on the card (the JAX rule's TPU, carried to CUDA) and a
    batch that divides them, ``"off"`` never."""
    if dp not in ("auto", "on", "off"):
        raise ValueError(f"dp must be 'auto', 'on' or 'off', got {dp!r}")
    use = world > 1 and (dp == "on" or (dp == "auto" and torch.device(device).type == "cuda"))
    if use and batch_size % world:
        if dp == "on":
            raise ValueError(f"dp='on' but batch_size {batch_size} does not divide the "
                             f"{world} devices")
        use = False
    return use


def _make_step(model, cfg: ExperimentConfig, streaming: bool, dp: bool):
    """``(step, loss_fn)``: the builder of the JAX ``fit``'s four-way choice
    (siamese or not, streaming or device store), data-parallel over every
    rank of the default group with ``dp``."""
    make = {(True, True): steps_mod.make_streaming_siamese_step,
            (True, False): steps_mod.make_streaming_classifier_step,
            (False, True): steps_mod.make_siamese_train_step,
            (False, False): steps_mod.make_classifier_train_step}[streaming,
                                                                  cfg.mode == "siamese"]
    return make(model, cfg, mesh_mod.data_mesh().get_group("data") if dp else None)


def fit(cfg: ExperimentConfig, train_store: Optional[AudioStore] = None,
        val_store: Optional[AudioStore] = None, device="cuda", verbose: bool = True,
        on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None, *,
        max_store_seconds: Optional[float] = 30.0, pipeline: str = "auto",
        streaming_threshold_bytes: Optional[int] = None, dp: str = "auto",
        ) -> Tuple[TrainState, List[Dict[str, Any]]]:
    """Train ``cfg`` → ``(final state, history)``.

    With ``train_store`` given, on that store through the device pipeline,
    evaluating on ``val_store`` (the training store, with a warning, when
    none is given). With no store, on the corpus of ``cfg.data``
    (``data/dataset.dataset_from_config``): ``pipeline="device"`` decodes it
    into a store on the card (each file cut to ``max_store_seconds``),
    ``"streaming"`` streams host-cut batches from disk
    (``StreamingPipeline(seed=cfg.train.seed)``, closed at the end, also on an
    exception), and ``"auto"`` streams when ``estimate_store_bytes`` is above
    ``streaming_threshold_bytes`` (default: ``STREAMING_THRESHOLD_SHARE`` of
    the device's memory, ``data/dataset.py``). The validation store is built
    from ``cfg.data.val_subsets`` at ``stochastic=False``; without them the
    training corpus is evaluated, with a warning (an error under
    ``require_holdout_eval``), a streaming run on a sub-store of files cut to
    at most 10 s.

    ``dp`` (:func:`use_data_parallel`): data-parallel over every rank of
    the default process group (``parallel/distributed.initialize``), the
    global batch ``batch_size``, each rank holding the whole store (device
    pipeline) or cutting the same host batches and keeping its rows
    (streaming, so every rank's host decodes the whole global batch);
    ``"on"`` with one rank warns and trains unsharded. Every rank builds the same model from the seed, restores the same checkpoint
    (the directory must be one that every rank reads) and evaluates with the
    same generator, so the plateau schedule stays replicated; only rank 0
    writes the records (which carry the metrics averaged over the ranks)
    and the checkpoints, and prints.

    Every ``evaluate_every`` steps and at the end: n-shot accuracy on the
    validation store, the plateau schedule, one JSONL record (loss, accuracy,
    ``val_{n}-shot_acc``, lr, ``utterances_per_sec`` of the steps since the
    last record; for a siamese net, of pairs) and, with ``checkpoint_dir``,
    the latest and best checkpoints. A run with a checkpoint in
    ``checkpoint_dir`` resumes from it. The dropout masks (and on the device
    pipeline the batch) of step i come from a generator seeded with (seed,
    i), so a resumed device-pipeline run draws what the first would have.
    ``on_step(i, metrics)``, when given, sees every step's metrics (0-d
    tensors on the device, not waited for).
    """
    t = cfg.train
    if cfg.mode not in ("classifier", "siamese", "melspec2d"):
        raise NotImplementedError(
            f"fit: classifier, siamese and melspec2d modes are ported, not {cfg.mode!r}")
    world = distributed.world_size()
    use_dp = use_data_parallel(dp, world, t.batch_size, device)
    if dp == "on" and world == 1:
        # up front, before any corpus decode, as the JAX fit warns
        warnings.warn(_DP_ONE_DEVICE_MSG, UserWarning, stacklevel=2)
    lead = distributed.rank() == 0
    verbose = verbose and lead
    if pipeline not in ("auto", "device", "streaming"):
        raise ValueError(f"pipeline must be 'auto', 'device' or 'streaming', got {pipeline!r}")
    if train_store is not None:
        if pipeline == "streaming":
            raise ValueError("a store given to fit trains through the device pipeline")
        pipeline = "device"
        store = steps_mod.device_store_for(cfg, train_store, device)
        if val_store is not None:
            val = steps_mod.device_store_for(cfg, val_store, device)
        else:
            _no_holdout(t, "no val_store given")
            val = store
        num_classes = len(train_store.label_names)
    else:
        train_ds, pipeline, store, val = _corpus_stores(
            cfg, device, max_store_seconds, pipeline, streaming_threshold_bytes, verbose)
        num_classes = train_ds.num_classes()
    model = init_model(cfg, num_classes, device, t.seed)
    state = init_state(model, t.clipnorm, t.learning_rate)
    streaming = pipeline == "streaming"
    step, loss_fn = _make_step(model, cfg, streaming, use_dp)
    if verbose:
        print(f"block 0: {'B4/B5' if loss_fn.fused_block0 else 'autograd'}, "
              f"blocks 1+: {loss_fn.blockn}, {pipeline} pipeline")
        if use_dp:
            print(f"data-parallel over {world} devices (local batch "
                  f"{t.batch_size // world}, {pipeline} pipeline)")
    ckpt = None
    if t.checkpoint_dir:
        ckpt = CheckpointManager(t.checkpoint_dir)
        if ckpt.restore_latest(state) is not None and verbose:
            print(f"resumed from step {state.step}")
        if not lead:  # every rank restores; rank 0 alone writes
            ckpt = None
    # As the reference's fit: a fresh schedule from the (restored) lr, with
    # no best and no bad count; the checkpoint's plateau state is not read.
    plateau = PlateauScheduler(state.lr, t.plateau_factor, t.plateau_patience, t.min_lr)

    stream = None
    if streaming:
        from ..data.pipeline import StreamingPipeline

        stream = StreamingPipeline(train_ds, cfg, seed=t.seed,
                                   mode="siamese" if cfg.mode == "siamese" else "classifier")
    log = JSONLWriter(t.log_path if lead else None)
    dev = val.audio.device
    gen = torch.Generator(device=dev)
    history: List[Dict[str, Any]] = []
    try:
        t_last = time.perf_counter()
        steps_since = 0
        for i in range(state.step, t.num_steps):
            gen.manual_seed(t.seed * 1_000_003 + i)
            if stream is not None:
                state, m = step(state, *next(stream), gen)
            else:
                state, m = step(state, store, gen)
            steps_since += 1
            if on_step is not None:
                on_step(i, m)
            if (i + 1) % t.evaluate_every == 0 or (i + 1) == t.num_steps:
                loss, acc_train = float(m["loss"]), float(m["accuracy"])  # waits for the device
                utt_per_s = steps_since * t.batch_size / max(time.perf_counter() - t_last, 1e-9)
                model.eval()
                eval_gen = torch.Generator(device=dev).manual_seed(t.seed + 1 + i)
                # As the reference's fit: the table comes from the model's own
                # forward (fast=False), whatever the step trains through; a
                # siamese net's head scores the tasks (B9 for weighted_l1).
                acc = nshot.evaluate(model, val, cfg, eval_gen, num_tasks=t.num_eval_tasks,
                                     n=t.n_shot, k=t.k_way, fast=False)
                model.train()
                state.lr = plateau.update(acc)
                rec = log.write(i + 1, loss=loss, accuracy=acc_train,
                                **{f"val_{t.n_shot}-shot_acc": acc}, lr=state.lr,
                                utterances_per_sec=utt_per_s)
                history.append(rec)
                if verbose:
                    print(rec)
                if ckpt:
                    ckpt.save(state, plateau)
                    ckpt.save_best(state, acc, plateau)
                t_last = time.perf_counter()
                steps_since = 0
    finally:
        if stream is not None:
            stream.close()
        log.close()
    return state, history
