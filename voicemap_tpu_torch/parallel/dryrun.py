"""One step of every parallelism of the port over n ranks: the multichip
dry run.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``, at
its tiny config (filters 8, embedding 16, f32, batch 2·n) and on its tiny
store (6 speakers × 4 utterances of 12,000 random int16 samples):

- ``dp``: the data-parallel siamese step (``parallel/data_parallel``);
- ``sp``: the halo-exchange encoder forward with time sharded over all ranks
  (``parallel/halo_conv``);
- ``ring``: the ring distance matrix and the sharded nearest support
  (``parallel/sharded_distance``);
- ``tp``: the two-layer tensor-parallel block and the real encoder's embed
  column-parallel on a ``{data n/2, model 2}`` mesh (``parallel/tensor_parallel``);
- ``pp``, ``pp-bwd``: GPipe over all ranks as stages, forward and one
  train step's gradients (``parallel/pipeline_parallel``);
- ``pp-real``: the two-stage real-encoder pipeline's train step on a
  ``{pp 2}`` mesh of the first two ranks, and its running statistics;
- ``dp_sp``: one data × seq step on a ``{data 2, seq n/2}`` mesh
  (``parallel/dp_sp``);
- ``dp-stream``: the data-parallel streaming classifier step.

:func:`dryrun_rank` runs inside an existing process group and returns the
nine fields of the JAX dry run's line, by its names and in its order, with
its ``skipped(n<…)`` rules; :func:`line` prints them as JAX does. The JAX
dry run's fragment is 2,048 samples, which 32·n divides for n a power of 2
(every block's pool must divide a shard); for another n it is rounded up to
the next multiple of 32·n (2,112 at n = 6), the shapes the line prints do
not change. :func:`dryrun_multichip` spawns n ranks on a file rendezvous
(gloo; on the card each rank keeps its tensors there and the collectives
stage through the host) and prints rank 0's line::

    python -m voicemap_tpu_torch.parallel.dryrun --n 4 --device cpu
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig
from ..data.store import AudioStore
from ..train.loop import init_model
from ..train.state import init_state
from ..train.steps import device_store_for
from . import comm, data_parallel, distributed, dp_sp, halo_conv, pipeline_parallel
from . import sharded_distance, tensor_parallel
from .mesh import data_mesh, make_mesh

FIELDS = ("dp", "sp", "ring", "tp", "pp", "pp-bwd", "pp-real", "dp_sp", "dp-stream")
TOL = 1e-4  # the JAX dry run's rtol and atol for its TP and PP checks


def tiny_cfg(batch_size: int = 8, mode: str = "siamese", seconds: float = 0.512
             ) -> ExperimentConfig:
    """The JAX dry run's ``_tiny_cfg``."""
    return ExperimentConfig(
        mode=mode, data=DataConfig(seconds=seconds, sample_rate=16000, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, compute_dtype="float32"),
        siamese=SiameseConfig(),
        train=TrainConfig(batch_size=batch_size, learning_rate=1e-3))


def tiny_store(num_speakers: int = 6, utts_per_speaker: int = 4, t_store: int = 12000,
               seed: int = 0) -> AudioStore:
    """The JAX dry run's ``_tiny_store`` on the host."""
    rng = np.random.default_rng(seed)
    n = num_speakers * utts_per_speaker
    return AudioStore(
        audio=rng.integers(-20000, 20000, size=(n, t_store), dtype=np.int16),
        lengths=np.full((n,), t_store, np.int32),
        labels=np.repeat(np.arange(num_speakers), utts_per_speaker).astype(np.int32),
        speaker_utts=np.arange(n, dtype=np.int32).reshape(num_speakers, utts_per_speaker),
        speaker_counts=np.full((num_speakers,), utts_per_speaker, np.int32),
        sample_rate=16000, label_names=list(range(num_speakers)))


def model_length(n: int) -> int:
    """The fragment's decimated length at n ranks: 2,048 where 32·n divides
    it, else the next multiple of 32·n."""
    step = 32 * n
    return 2048 if 2048 % step == 0 else step * math.ceil(2048 / step)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _finite(x) -> bool:
    return bool(torch.isfinite(torch.as_tensor(x)).all())


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def dryrun_rank(rank: int, world: int, device="cuda") -> dict:
    """Every program of the dry run on this rank of the default group (of
    ``world`` ranks) → ``{field: value}`` in :data:`FIELDS` order; the
    values are the same on every rank that takes part (losses as floats,
    shapes as tuples, ``"skipped(n<k)"`` where the world is too small)."""
    dev = torch.device(device)
    n = world
    T = model_length(n)
    seconds = T * 4 / 16000
    host = tiny_store()
    mesh = data_mesh(n)
    ax = comm.axis(mesh, "data")
    f32 = dict(dtype=torch.float32, device=dev)
    out = {}

    # --- DP: one data-parallel siamese step.
    cfg = tiny_cfg(batch_size=2 * n, seconds=seconds)
    model = init_model(cfg, 6, dev, seed=0)
    store = device_store_for(cfg, host, dev)
    step, _ = data_parallel.make_dp_siamese_train_step(model, cfg, mesh)
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    state, metrics = step(state, store, _gen(dev, 0))
    loss = float(metrics["loss"])
    _check(math.isfinite(loss) and state.step == 1, f"DP step: loss {loss}")
    out["dp"] = loss

    # --- SP: the halo-exchange encoder forward, time sharded over every rank.
    encoder = model.encoder.eval()  # the step left it in train mode
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, T, 1)), **f32)
    t_loc = T // n
    embed = halo_conv.make_sharded_embed_fn(cfg.encoder, mesh, axis="data")
    with torch.no_grad():
        emb = embed(encoder, x[:, rank * t_loc:(rank + 1) * t_loc])
    _check(_finite(emb), "halo-conv embedding non-finite")
    out["sp"] = tuple(emb.shape)

    # --- The ring distance matrix and the nearest support.
    r = np.random.default_rng(2)
    q = torch.as_tensor(r.standard_normal((2 * n, 16)), **f32)
    s = torch.as_tensor(r.standard_normal((4 * n, 16)), **f32)
    block = sharded_distance.ring_sq_euclidean(q[2 * rank:2 * rank + 2],
                                               s[4 * rank:4 * rank + 4], mesh)
    d = sharded_distance.gather_columns(block, mesh)
    nearest = sharded_distance.sharded_nearest_support(q, s[4 * rank:4 * rank + 4], mesh)
    _check(_finite(d) and tuple(nearest.shape) == (2 * n,), "ring distances")
    out["ring"] = tuple(d.shape)

    # --- TP: the two-layer block and the encoder's embed head on {data, model}.
    out["tp"] = "skipped(n<2)"
    if n >= 2 and n % 2 == 0:
        mesh2 = make_mesh({"data": n // 2, "model": 2})
        w1 = torch.as_tensor(r.standard_normal((16, 4 * n)), **f32)
        b1 = torch.as_tensor(r.standard_normal((4 * n,)), **f32)
        w2 = torch.as_tensor(r.standard_normal((4 * n, 8)), **f32)
        b2 = torch.as_tensor(r.standard_normal((8,)), **f32)
        x_tp = torch.as_tensor(r.standard_normal((4, 16)), **f32)
        with torch.no_grad():
            y_tp = tensor_parallel.make_tp_mlp(mesh2, axis="model")(x_tp, w1, b1, w2, b2)
            expect = torch.relu(x_tp @ w1 + b1) @ w2 + b2
        _check(torch.allclose(y_tp, expect, rtol=TOL, atol=TOL), "TP block mismatch")
        out["tp"] = tuple(y_tp.shape)
        x_enc = torch.as_tensor(np.random.default_rng(3).standard_normal((n, T, 1)), **f32)
        d_idx = comm.axis(mesh2, "data").index
        x_mine = x_enc[2 * d_idx:2 * d_idx + 2]
        tp_emb = tensor_parallel.make_tp_encoder_embed_fn(cfg.encoder, mesh2)(encoder, x_mine)
        with torch.no_grad():
            want = encoder(x_mine)
        _check(torch.allclose(tp_emb, want, rtol=TOL, atol=TOL), "TP real-encoder mismatch")

    # --- DP × SP: one step on {data 2, seq n/2}.
    out["dp_sp"] = "skipped(n<4)"
    if n >= 4 and n % 2 == 0:
        mesh_ds = make_mesh({"data": 2, "seq": n // 2})
        cfg_ds = tiny_cfg(batch_size=4, mode="classifier", seconds=seconds)
        clf = init_model(cfg_ds, 6, dev, seed=1)
        step_ds, _ = dp_sp.make_dp_sp_classifier_train_step(clf, cfg_ds, mesh_ds)
        st = init_state(clf, cfg_ds.train.clipnorm, cfg_ds.train.learning_rate)
        st, m_ds = step_ds(st, device_store_for(cfg_ds, host, dev), _gen(dev, 3))
        loss_ds = float(m_ds["loss"])
        _check(math.isfinite(loss_ds) and st.step == 1, f"DP×SP step: loss {loss_ds}")
        out["dp_sp"] = loss_ds

    # --- DP over host-streamed batches.
    cfg_st = tiny_cfg(batch_size=2 * n, mode="classifier", seconds=seconds)
    clf_st = init_model(cfg_st, 6, dev, seed=2)
    step_st, _ = data_parallel.make_dp_streaming_classifier_step(clf_st, cfg_st, mesh)
    r_st = np.random.default_rng(4)
    frags = r_st.integers(-2000, 2000, (2 * n, cfg_st.data.fragment_length)).astype(np.int16)
    y_st = r_st.integers(0, 6, (2 * n,)).astype(np.int32)
    st_state = init_state(clf_st, cfg_st.train.clipnorm, cfg_st.train.learning_rate)
    st_state, m_st = step_st(st_state, frags, y_st, _gen(dev, 5))
    stream_loss = float(m_st["loss"])
    _check(math.isfinite(stream_loss) and st_state.step == 1, "DP streaming step")
    out["dp-stream"] = stream_loss

    # --- PP: GPipe with every rank a stage.
    def stage(params, act):
        w, b = params
        return torch.relu(act @ w + b)

    D, n_micro = 8, 4
    ws = torch.as_tensor(r.standard_normal((n, D, D)) * 0.3, **f32)
    bs = torch.zeros((n, D), **f32)
    x_pp = torch.as_tensor(r.standard_normal((n_micro, 2, D)), **f32)
    mine = (ws[rank:rank + 1], bs[rank:rank + 1])
    y_pp = pipeline_parallel.make_gpipe_fn(mesh, stage, n_micro, axis="data")(mine, x_pp)
    expect_pp = x_pp
    for si in range(n):
        expect_pp = torch.relu(expect_pp @ ws[si] + bs[si])
    _check(torch.allclose(y_pp, expect_pp, rtol=TOL, atol=TOL), "PP pipeline mismatch")
    out["pp"] = tuple(y_pp.shape)

    pp_step = pipeline_parallel.make_gpipe_train_step(
        mesh, stage, lambda o, tgt: torch.mean((o - tgt) ** 2), n_micro, axis="data")
    pp_loss, pp_grads = pp_step(mine, x_pp, expect_pp + 1.0)
    biggest = comm.all_reduce_(pp_grads[0].abs().max().reshape(1), ax.group,
                               dist.ReduceOp.MAX)
    _check(math.isfinite(float(pp_loss)) and float(pp_loss) > 0.0, "PP loss")
    _check(pp_grads[0].shape == mine[0].shape and float(biggest) > 0.0, "PP grads all zero")
    out["pp-bwd"] = float(pp_loss)

    # --- PP over the real encoder: two stages on {pp 2}, train mode.
    out["pp-real"] = "skipped(n<2)"
    if n >= 2:
        mesh_pp = make_mesh({"pp": 2})  # every rank builds it; ranks 0 and 1 run it
        if rank < 2:
            mb_r, nm_r, E = 2, 3, cfg.encoder.embedding_dim
            x_ppr = torch.as_tensor(r.standard_normal((nm_r, mb_r, T, 1)), **f32)
            y_ppr = torch.as_tensor(r.standard_normal((nm_r, mb_r, E)), **f32)
            ppr_step, ppr_pack, ppr_apply = pipeline_parallel.make_gpipe_real_train_step(
                cfg.encoder, mesh_pp, encoder, mb_r, T, nm_r,
                lambda o, tgt: torch.mean((o - tgt) ** 2))
            ppr_loss, ppr_grads, ppr_stats = ppr_step(ppr_pack(encoder), x_ppr, y_ppr)
            pp_axis = comm.axis(mesh_pp, "pp")
            biggest = comm.all_reduce_(ppr_grads.abs().max().reshape(1), pp_axis.group,
                                       dist.ReduceOp.MAX)
            _check(math.isfinite(float(ppr_loss)), "pp-real non-finite loss")
            _check(float(biggest) > 0.0, "pp-real grads zero")
            new = ppr_apply(encoder, ppr_stats)
            bn0 = new["block_0"]["bn"]
            moved = float((bn0["mean"] - encoder.blocks[0].bn.running_mean).abs().max())
            _check(_finite(bn0["mean"]) and moved > 0.0,
                   "pp-real BN running stats did not update")
            out["pp-real"] = float(ppr_loss)
        # rank 0's loss, for the ranks outside the pipeline
        val = torch.tensor([out["pp-real"] if rank == 0 else 0.0], **f32)
        out["pp-real"] = float(comm.all_reduce_(val, ax.group))
    return {k: out[k] for k in FIELDS}


def line(n: int, fields: dict) -> str:
    """The JAX dry run's line from :func:`dryrun_rank`'s fields."""
    def num(v):
        return v if isinstance(v, str) else f"{v:.4f}"

    return (f"dryrun_multichip ok: {n} devices, dp loss={fields['dp']:.4f}, "
            f"sp embed shape={fields['sp']}, ring distance {fields['ring']}, "
            f"tp block {fields['tp']}, pp out {fields['pp']}, "
            f"pp-bwd loss={fields['pp-bwd']:.4f}, pp-real loss={num(fields['pp-real'])}, "
            f"dp_sp loss={num(fields['dp_sp'])}, dp-stream loss={fields['dp-stream']:.4f}")


def _rank_main(rank: int, world: int, rendezvous: str, device: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    distributed.initialize(rendezvous, world, rank, device=device, backend="gloo")
    try:
        fields = dryrun_rank(rank, world, device)
        if rank == 0:
            torch.save(fields, os.path.join(out_dir, "fields.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda", timeout: float = 600.0) -> str:
    """Spawn ``n`` ranks in one gloo group on a file rendezvous, run
    :func:`dryrun_rank` on each, and return (and print) rank 0's line. On the
    card every rank keeps its tensors on the one card; the collectives stage
    through the host (``parallel/comm``)."""
    with tempfile.TemporaryDirectory(prefix="voicemap_dryrun_") as tmp:
        distributed.spawn(_rank_main, n, (n, f"file://{os.path.join(tmp, 'rendezvous')}",
                                          str(device), tmp), timeout)
        text = line(n, torch.load(os.path.join(tmp, "fields.pt"), weights_only=False))
    print(text, flush=True)
    return text


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="The multichip dry run over n ranks.")
    parser.add_argument("--n", type=int, default=4, help="ranks to spawn")
    parser.add_argument("--device", default="cuda", help="cuda (every rank on the card) or cpu")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
