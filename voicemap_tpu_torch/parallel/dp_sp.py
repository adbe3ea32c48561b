"""2-D (data × seq) parallel training: data parallelism × halo-exchange
sequence parallelism.

Port of ``voicemap_tpu/parallel/dp_sp.py``: the batch is split over the
``data`` axis of a ``{data, seq}`` mesh and each fragment's TIME axis over
the ``seq`` axis, the halo-exchange convs (``parallel/halo_conv``)
reassembling the receptive fields across shard boundaries.

Why averaging over both axes gives the single-device gradient: every
collective's backward is the adjoint of its forward over the whole axis
(``parallel/comm``), so a rank's gradient is that of the sum of every
rank's loss through its own path. Within a data row every seq rank computes
the same loss L_r (the global max all-gathers the shards), so the gradients
of the ``n_seq · n_data`` ranks sum to ``n_seq · Σ_r ∂L_r/∂θ``; the mean over
seq and then over data is ``∂(mean_r L_r)/∂θ``, the full batch's loss for
equal sub-batches. BatchNorm's statistics are averaged over both axes inside
the forward (``pmean``, whose backward is ``pmean``), so they are the full
batch's: the step is the single-device full-batch step, which the tests hold.

The model carries its parameters, so ``make_dp_sp_classifier_train_step``
takes it, as ``parallel/data_parallel``'s ``make_dp_*`` do; the step
updates it in place.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import ExperimentConfig
from ..models.classifier import SpeakerClassifier
from ..models.convert import variables_of
from ..ops import sampling
from ..train import losses
from ..train import steps as steps_mod
from ..train.state import TrainState, apply_updates
from . import comm
from .comm import Axis
from .halo_conv import full_f32, sharded_encoder_train_apply


def dp_sp_classifier_loss_fn(cfg: ExperimentConfig, data_axis: Axis, seq_axis: Axis
                             ) -> Callable:
    """``loss_fn(params, batch_stats, x_local, y, generator) → (loss,
    (new_batch_stats, accuracy))`` on this rank's ``(B_local, T_local, 1)``
    time shard; the trees are ``variables_of(classifier)``'s."""
    enc_cfg = cfg.encoder

    def loss_fn(params, batch_stats, x_local, y, generator):
        emb, new_enc_bs = sharded_encoder_train_apply(
            params["encoder"], batch_stats["encoder"], enc_cfg, x_local, seq_axis,
            (data_axis, seq_axis), generator)
        head = params["head"]
        with full_f32():
            logits = emb @ head["kernel"].float() + head["bias"].float()
        return (losses.softmax_ce(logits, y),
                ({"encoder": new_enc_bs}, losses.categorical_accuracy(logits, y)))

    return loss_fn


@torch.no_grad()
def _mean_over(state: TrainState, metrics: Tuple[torch.Tensor, ...], axes) -> tuple:
    """Every gradient and ``metrics`` averaged over each axis of ``axes`` in
    turn (one ``all_reduce`` of one flat f32 vector an axis), in place; →
    the averaged metrics."""
    grads = [p.grad for p in state.optimizer.params if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [m.detach().reshape(1).float() for m in metrics])
    for ax in axes:
        comm.all_reduce_(flat, ax.group)
        flat /= ax.size
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return tuple(flat[off:])


@torch.no_grad()
def _write_stats(batch_stats: dict, new: dict) -> None:
    """The new running statistics into the module's buffers (the views of
    ``variables_of``), leaf by leaf."""
    for buf, value in zip(comm.tree_flatten(batch_stats)[0], comm.tree_flatten(new)[0]):
        buf.copy_(value)


def make_dp_sp_classifier_train_step(model: SpeakerClassifier, cfg: ExperimentConfig,
                                     mesh: DeviceMesh, data_axis: str = "data",
                                     seq_axis: str = "seq"):
    """``(step, loss_fn)``; ``step(state, store, generator) → (state,
    metrics)`` over a 2-D ``{data, seq}`` mesh.

    Each data row draws its own ``batch_size / n_data`` utterances from
    ``train/steps.rank_generator`` of the step's generator and its data
    index only, so every seq rank of the row draws the same batch, offsets
    and dropout masks; it fetches the full fragments (B1 on a decimated
    store), keeps its time shard, runs the halo train forward with the
    statistics over both axes, averages the gradients, loss and accuracy
    over seq and then over data, writes the new running statistics (already
    reduced inside the forward) and applies the update. The model's state is
    the same on every rank after it."""
    t = cfg.train
    dax, sax = comm.axis(mesh, data_axis), comm.axis(mesh, seq_axis)
    if t.batch_size % dax.size:
        raise ValueError(f"data-axis size {dax.size} must divide the global batch "
                         f"{t.batch_size}")
    local_b = t.batch_size // dax.size
    T = cfg.data.model_length
    if T % sax.size:
        raise ValueError(f"seq-axis size {sax.size} must divide model_length {T}")
    t_loc = T // sax.size
    loss_fn = dp_sp_classifier_loss_fn(cfg, dax, sax)

    def step(state: TrainState, store: steps_mod.DeviceStore,
             generator: Optional[torch.Generator]):
        if generator is None:
            raise ValueError("a data × seq step draws its sub-batch from a seeded generator")
        gen = steps_mod.rank_generator(generator, dax.index)  # never the seq index
        idx = sampling.sample_classifier_batch(gen, store.labels.shape[0], local_b,
                                               store.audio.device)
        x = steps_mod.fetch_batch(store, idx, cfg, gen, cfg.data.stochastic)
        x_local = x[:, sax.index * t_loc:(sax.index + 1) * t_loc]
        state.optimizer.zero_grad()
        state.model.train()
        v = variables_of(state.model)
        loss, (new_bs, acc) = loss_fn(v["params"], v["batch_stats"], x_local,
                                      store.labels[idx], gen)
        loss.backward()
        loss, acc = _mean_over(state, (loss, acc), (sax, dax))
        _write_stats(v["batch_stats"], new_bs)
        apply_updates(state)
        return state, {"loss": loss, "accuracy": acc}

    return step, loss_fn
