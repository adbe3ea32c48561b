"""The training loop: steps → periodic n-shot eval → plateau LR → checkpoints
→ JSONL metrics.

Port of ``voicemap_tpu/train/loop.py :: fit`` for the device pipeline in
classifier mode on one card. The JAX ``fit`` reads its corpus through
``data/dataset.py`` (pandas and LibriSpeech on disk); this one takes an
``AudioStore`` (``data/store.py``), which the caller builds, for example
with ``synthetic_store``. Not ported yet: siamese steps, the streaming
pipeline, data parallel, and the ``fused_recompute`` and ``fused_int8``
train forwards.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..config import ExperimentConfig
from ..data.store import AudioStore
from ..eval import nshot
from ..models.classifier import SpeakerClassifier
from . import steps as steps_mod
from .checkpoints import CheckpointManager
from .metrics import JSONLWriter, PlateauScheduler
from .state import TrainState, init_state

_LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def init_model(cfg: ExperimentConfig, num_classes: int, device, seed: int) -> SpeakerClassifier:
    """A classifier initialised as flax initialises it, from ``seed``: conv
    and Dense kernels lecun-normal (truncated at two standard deviations),
    biases zero, BatchNorm scale 1, bias 0, running mean 0, variance 1."""
    model = SpeakerClassifier(cfg.encoder, num_classes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Linear)):
                std = mod.weight[0].numel() ** -0.5 / _LECUN_TRUNC
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std, generator=gen)
                mod.bias.zero_()
    return model


def fit(cfg: ExperimentConfig, train_store: AudioStore, val_store: Optional[AudioStore] = None,
        device="cuda", verbose: bool = True,
        on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
        ) -> Tuple[TrainState, List[Dict[str, Any]]]:
    """Train ``cfg`` on ``train_store`` → ``(final state, history)``.

    Every ``evaluate_every`` steps and at the end: n-shot accuracy on
    ``val_store`` (the training store, with a warning, when none is given),
    the plateau schedule, one JSONL record (loss, accuracy,
    ``val_{n}-shot_acc``, lr, ``utterances_per_sec`` of the steps since the
    last record) and, with ``checkpoint_dir``, the latest and best
    checkpoints. A run with a checkpoint in ``checkpoint_dir`` resumes from
    it. The batch of step i is drawn from a generator seeded with
    (seed, i), so a resumed run draws what the first would have.
    ``on_step(i, metrics)``, when given, sees every step's metrics (0-d
    tensors on the device, not waited for).
    """
    t = cfg.train
    if cfg.mode != "classifier":
        raise NotImplementedError(f"fit: only classifier mode is ported, not {cfg.mode!r}")
    store = steps_mod.device_store_for(cfg, train_store, device)
    if val_store is not None:
        val = steps_mod.device_store_for(cfg, val_store, device)
    else:
        msg = ("no val_store given — n-shot eval (best-model gating + LR plateau) runs on "
               "the TRAINING store, which overstates accuracy")
        if t.require_holdout_eval:
            raise ValueError(msg)
        warnings.warn(msg, UserWarning, stacklevel=2)
        val = store
    model = init_model(cfg, len(train_store.label_names), device, t.seed)
    state = init_state(model, t.clipnorm, t.learning_rate)
    step, loss_fn = steps_mod.make_classifier_train_step(model, cfg)
    if verbose:
        print(f"block 0: {'B4/B5' if loss_fn.fused_block0 else 'autograd'}, "
              f"blocks 1+: {loss_fn.blockn}")
    plateau = PlateauScheduler(state.lr, t.plateau_factor, t.plateau_patience, t.min_lr)
    ckpt = None
    if t.checkpoint_dir:
        ckpt = CheckpointManager(t.checkpoint_dir)
        if ckpt.restore_latest(state, plateau) is not None and verbose:
            print(f"resumed from step {state.step}")

    log = JSONLWriter(t.log_path)
    gen = torch.Generator(device=store.audio.device)
    history: List[Dict[str, Any]] = []
    t_last = time.perf_counter()
    steps_since = 0
    for i in range(state.step, t.num_steps):
        gen.manual_seed(t.seed * 1_000_003 + i)
        state, m = step(state, store, gen)
        steps_since += 1
        if on_step is not None:
            on_step(i, m)
        if (i + 1) % t.evaluate_every == 0 or (i + 1) == t.num_steps:
            loss, acc_train = float(m["loss"]), float(m["accuracy"])  # waits for the device
            utt_per_s = steps_since * t.batch_size / max(time.perf_counter() - t_last, 1e-9)
            model.eval()
            eval_gen = torch.Generator(device=store.audio.device).manual_seed(t.seed + 1 + i)
            # The evaluation embeds through B2 where the step trains through B4/B5.
            acc = nshot.evaluate(model, val, cfg, eval_gen, num_tasks=t.num_eval_tasks,
                                 n=t.n_shot, k=t.k_way, fast=loss_fn.fused_block0)
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
    log.close()
    return state, history
