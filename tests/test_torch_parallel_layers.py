"""Sequence, tensor and pipeline parallelism on the port
(``voicemap_tpu_torch/parallel/{comm,halo_conv,dp_sp,tensor_parallel,
pipeline_parallel,dryrun}.py``) at world size 4 on gloo, on the CPU.

One process group serves the module: ``ranks`` spawns four processes once
(``test_torch_pod_eval.spawn``), each runs every case below on the meshes
the case names and saves what it got, and the tests read the files. The JAX
side runs here, on meshes of the faked CPU devices, from the same
numpy-seeded inputs, the weights carried across with ``models/convert``
(flax's init, BatchNorm statistics randomized). The cases mirror
``tests/test_parallel.py``, on meshes of four. Tolerances, each with its
reason:

- forwards against the JAX package's sharded and dense ones: 1e-4 (the JAX
  tests' own; the frameworks sum convs in other orders);
- gradients through the halo exchange against the dense gradients: rtol
  2e-3, atol 1e-4 (the JAX test's); against the port's own dense gradients,
  rtol 1e-4, atol 1e-6 (one framework, the halo conv's VALID sum against the
  SAME one);
- data × seq gradients against the single-device full batch: the loss to
  1e-5 relative (the JAX test's), gradients rtol 2e-3, atol 2e-5 against
  JAX (its test's), and against the port's single-device step rtol 1e-4,
  atol 1e-6, the new running statistics 1e-5;
- the collectives' transposes against JAX's: equal but for the order of a
  four-term sum (1e-6);
- GPipe against JAX and the sequential stages: 1e-5 for the homogeneous
  pipeline's outputs and gradients (the JAX test's for its gradients);
  the real encoder's eval outputs 1e-4, its train loss 1e-5 relative and
  gradients rtol 1e-4, atol 1e-5 (the JAX test's), the chained running
  statistics rtol 1e-5, atol 1e-6 (the JAX test's);
- the real-encoder pipeline's eval against the port's ``fast_embed``: 1e-6
  (the same functions on the same values; the CPU's plain versions);
- the refusals: the JAX message where the two raise one (``ValueError``),
  a raise on both sides where JAX's comes from a reshape or ``in_specs``.
"""

import dataclasses
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn, to_numpy
from test_torch_pod_eval import spawn
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.models.encoder import ConvEncoder as JaxEncoder
from voicemap_tpu.models.fast_infer import fast_embed as jax_fast_embed
from voicemap_tpu.parallel import dp_sp as jdp_sp
from voicemap_tpu.parallel import halo_conv as jhalo
from voicemap_tpu.parallel import mesh as jmesh
from voicemap_tpu.parallel import pipeline_parallel as jpp
from voicemap_tpu.parallel import tensor_parallel as jtp
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu_torch.config import DataConfig, EncoderConfig, ExperimentConfig, TrainConfig
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.models import fused_train
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, to_flax, variables_of
from voicemap_tpu_torch.models.encoder import ConvEncoder
from voicemap_tpu_torch.models.fast_infer import fast_embed
from voicemap_tpu_torch.ops import sampling
from voicemap_tpu_torch.parallel import (
    comm, distributed, dp_sp, dryrun, halo_conv, pipeline_parallel, tensor_parallel,
)
from voicemap_tpu_torch.parallel.mesh import make_mesh
from voicemap_tpu_torch.train import losses, steps
from voicemap_tpu_torch.train.state import init_state

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
FWD_TOL = 1e-4
HALO_GRAD = dict(rtol=2e-3, atol=1e-4)
OWN_GRAD = dict(rtol=1e-4, atol=1e-6)
DPSP_JAX = dict(rtol=2e-3, atol=2e-5)
LOSS_RTOL = 1e-5
STATS_TOL = 1e-5
COMM_TOL = 1e-6
GPIPE_TOL = 1e-5
REAL_GRAD = dict(rtol=1e-4, atol=1e-5)
CHAIN = dict(rtol=1e-5, atol=1e-6)
OWN_EVAL = 1e-6
ENC = EncoderConfig(filters=4, embedding_dim=8, dropout=0.0, compute_dtype="float32")
DIL = dataclasses.replace(ENC, filter_multipliers=(1, 2), kernel_sizes=(16, 3),
                          pool_sizes=(4, 2), dilations=(1, 4))
ONE_BLOCK = dataclasses.replace(ENC, filter_multipliers=(1,), kernel_sizes=(32,),
                                pool_sizes=(4,), dilations=(1,))
SPEAKERS = 4
DPSP_B, DPSP_T = 16, 1024
STEP_SEED, STEP_COUNT = 7, 20
D_PP, MB_PP = 16, 4


def step_cfg(dropout=0.0, batch=8, seconds=0.256):
    """The data × seq step's config: DIL's blocks (pools 4 · 2 divide the
    256-sample shards at T = 1024 over seq 2)."""
    return ExperimentConfig(
        mode="classifier", data=DataConfig(seconds=seconds, downsampling=4),
        encoder=dataclasses.replace(DIL, dropout=dropout),
        train=TrainConfig(batch_size=batch, learning_rate=3e-3))


def host_store():
    return synthetic_store(3, n_speakers=SPEAKERS, utterances_per_speaker=4,
                           min_seconds=0.3, max_seconds=0.5)


def encoder_of(cfg, variables):
    enc = ConvEncoder(cfg, device="cpu")
    enc.load_state_dict(from_flax(variables, cfg))
    return enc


def classifier_of(cfg, variables):
    clf = SpeakerClassifier(cfg, SPEAKERS, device="cpu")
    clf.load_state_dict(from_flax(variables, cfg))
    return clf


def grads_of(module) -> dict:
    return {k: p.grad.clone() for k, p in module.named_parameters() if p.grad is not None}


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _stage(params, x):
    w, b = params
    return torch.relu(x @ w + b)


def _mse(out, y):
    return torch.mean((out - y) ** 2)


def _half_sse(out, y):
    return 0.5 * torch.sum((out - y) ** 2)


def _pack_grads(cfg, grads: dict, pack):
    """A module's gradients in the pipeline's flat row: a module holding
    them as its parameters and zeros as its statistics, packed."""
    g = ConvEncoder(cfg, device="cpu")
    sd = {k: torch.zeros_like(v) for k, v in g.state_dict().items()}
    sd.update(grads)
    g.load_state_dict(sd)
    return pack(g)


def _layers_rank(rank: int, world: int, rendezvous: str, tmp: str) -> None:
    """One rank: every case of the module, its results saved to rank<r>.pt."""
    torch.set_num_threads(1)
    assert distributed.initialize(rendezvous, world, rank, device="cpu")
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = {}
        mesh_seq = make_mesh({"seq": 4})
        mesh_ds = make_mesh({"data": 2, "seq": 2})
        mesh_dm = make_mesh({"data": 2, "model": 2})
        mesh_m = make_mesh({"model": 4})
        mesh_pp4 = make_mesh({"pp": 4})
        mesh_pp2 = make_mesh({"pp": 2})
        d_idx, s_idx = rank // 2, rank % 2  # place on the 2 × 2 meshes

        # the collectives and their backwards
        ax = comm.axis(mesh_seq, "seq")
        x = inp["comm_x"][rank].clone().requires_grad_()
        for name, fn, ct in (
                ("shift", lambda v: comm.shift(v, ax, 1), inp["comm_ct"][rank]),
                ("gather", lambda v: comm.all_gather(v, ax, dim=0, tiled=True),
                 inp["comm_ctg"][rank]),
                ("psum", lambda v: comm.psum(v, ax), inp["comm_ct"][rank]),
                ("pmean", lambda v: comm.pmean(v, ax), inp["comm_ct"][rank])):
            x.grad = None
            y = fn(x)
            y.backward(ct)
            out[f"comm_{name}"] = (y.detach(), x.grad.clone())

        # the halo encoder at seq 4, dilated, and its gradients
        for case, cfg in (("halo", ENC), ("halo_dil", DIL)):
            enc = encoder_of(cfg, inp[f"{case}_vars"])
            xs = inp[f"{case}_x"]
            t = xs.shape[1] // 4
            embed = halo_conv.make_sharded_embed_fn(cfg, mesh_seq, axis="seq")
            got = embed(enc, xs[:, rank * t:(rank + 1) * t])
            out[case] = got.detach()
            if case == "halo":
                (got ** 2).sum().backward()
                out["halo_grads"] = grads_of(enc)
                dense = encoder_of(cfg, inp[f"{case}_vars"])
                (dense(xs) ** 2).sum().backward()
                out["halo_dense_grads"] = grads_of(dense)
                out["halo_dense"] = dense(xs).detach()
        tiny = ConvEncoder(ENC, device="cpu")
        xs = inp["halo_x"]
        out["error_halo_pool"] = _error(lambda: halo_conv.make_sharded_embed_fn(
            ENC, mesh_seq)(tiny, xs[:, :40]))

        # data × seq: the sharded loss's gradients against the full batch
        dax, sax = comm.axis(mesh_ds, "data"), comm.axis(mesh_ds, "seq")
        cfg_ds = step_cfg()
        clf = classifier_of(DIL, inp["dpsp_vars"])
        clf.train()
        xb, yb = inp["dpsp_x"], inp["dpsp_y"]
        rows = slice(d_idx * DPSP_B // 2, (d_idx + 1) * DPSP_B // 2)
        t_loc = DPSP_T // 2
        v = variables_of(clf)
        loss_fn = dp_sp.dp_sp_classifier_loss_fn(cfg_ds, dax, sax)
        loss, (new_bs, _) = loss_fn(v["params"], v["batch_stats"],
                                    xb[rows, s_idx * t_loc:(s_idx + 1) * t_loc], yb[rows], None)
        loss.backward()
        state = init_state(clf, 1e3, 1e-3)
        (loss_avg,) = dp_sp._mean_over(state, (loss,), (sax, dax))
        out["dpsp_loss"] = float(loss_avg)
        out["dpsp_grads"] = grads_of(clf)
        out["dpsp_stats"] = comm.tree_flatten(new_bs)[0]
        if rank == 0:  # the port's single-device full-batch reference
            ref = classifier_of(DIL, inp["dpsp_vars"])
            ref.train()
            logits = fused_train.classifier_train_forward(ref, xb, None, "jnp", False)
            ref_loss = losses.softmax_ce(logits, yb)
            ref_loss.backward()
            out["dpsp_ref"] = (float(ref_loss), grads_of(ref),
                               [b.clone() for b in comm.tree_flatten(
                                   variables_of(ref)["batch_stats"])[0]])

        # data × seq: the step, against the single-device step on its draws
        host = host_store()
        store = steps.device_store_for(cfg_ds, host, "cpu")
        clf = classifier_of(DIL, inp["step_vars"])
        step, _ = dp_sp.make_dp_sp_classifier_train_step(clf, cfg_ds, mesh_ds)
        st = init_state(clf, cfg_ds.train.clipnorm, cfg_ds.train.learning_rate)
        st, m = step(st, store, torch.Generator().manual_seed(STEP_SEED))
        out["step_one"] = (float(m["loss"]), grads_of(clf),
                           {k: b.clone() for k, b in clf.named_buffers()
                            if b.is_floating_point()})
        if rank == 0:
            ref = classifier_of(DIL, inp["step_vars"])
            xs_, ys_ = [], []
            for d in range(2):
                gen = steps.rank_generator(torch.Generator().manual_seed(STEP_SEED), d)
                idx = sampling.sample_classifier_batch(gen, store.labels.shape[0], 4)
                xs_.append(steps.fetch_batch(store, idx, cfg_ds, gen, cfg_ds.data.stochastic))
                ys_.append(store.labels[idx])
            ref_state = init_state(ref, cfg_ds.train.clipnorm, cfg_ds.train.learning_rate)
            ref_fn = steps.classifier_loss_fn(ref, cfg_ds)
            _, rm = steps.train_on_batch(ref_state, torch.cat(xs_), torch.cat(ys_), None,
                                         ref_fn)
            out["step_ref"] = (float(rm["loss"]), grads_of(ref),
                               {k: b.clone() for k, b in ref.named_buffers()
                                if b.is_floating_point()}, ref_fn.blockn, ref_fn.fused_block0)
        hist = [float(m["loss"])]
        for i in range(1, STEP_COUNT):
            st, m = step(st, store, torch.Generator().manual_seed(STEP_SEED + i))
            hist.append(float(m["loss"]))
        out["step_losses"] = hist
        out["step_params"] = {k: p.detach().clone() for k, p in clf.named_parameters()}

        # the dropout masks: one a (row, channel) a block, shared by a data row
        masks, real = [], halo_conv.spatial_dropout

        def recording(y, rate, gen, channel_dim=1):
            got = real(y, rate, gen, channel_dim)
            masks.append((got != 0).any(dim=2))
            return got

        halo_conv.spatial_dropout = recording
        try:
            cfg_drop = step_cfg(dropout=0.5)
            clf = classifier_of(DIL, inp["step_vars"])
            step, _ = dp_sp.make_dp_sp_classifier_train_step(clf, cfg_drop, mesh_ds)
            st = init_state(clf, 1.0, 1e-3)
            step(st, steps.device_store_for(cfg_drop, host, "cpu"),
                 torch.Generator().manual_seed(STEP_SEED))
        finally:
            halo_conv.spatial_dropout = real
        out["masks"] = masks

        clf = classifier_of(DIL, inp["step_vars"])
        out["error_batch"] = _error(lambda: dp_sp.make_dp_sp_classifier_train_step(
            clf, step_cfg(batch=5), mesh_ds))
        out["error_length"] = _error(lambda: dp_sp.make_dp_sp_classifier_train_step(
            clf, step_cfg(seconds=0.25625), mesh_ds))

        # tensor parallelism
        enc = encoder_of(ENC, inp["tp_vars"])
        xt = inp["tp_x"]
        fn = tensor_parallel.make_tp_encoder_embed_fn(ENC, mesh_dm)
        out["tp_embed"] = fn(enc, xt[4 * d_idx:4 * d_idx + 4]).clone()
        x_, w_, b_ = inp["head"]
        out["tp_head"] = tensor_parallel.make_tp_embed_head(mesh_m, "model")(x_, w_, b_)
        out["tp_head_2d"] = tensor_parallel.make_tp_embed_head(mesh_dm, "model")(
            *inp["head_2d"])
        mlp_in = [t.clone().requires_grad_() for t in inp["mlp"]]
        y = tensor_parallel.make_tp_mlp(mesh_m, "model")(*mlp_in)
        (y ** 2).sum().backward()
        out["tp_mlp"] = (y.detach(), [t.grad.clone() for t in mlp_in])
        out["error_tp"] = _error(lambda: tensor_parallel.make_tp_mlp(mesh_m, "model")(
            *_narrow_mlp(inp["mlp"])))

        # GPipe: against sequential, at one microbatch, its gradients, learning
        ws, bs, xp = inp["pp_w"], inp["pp_b"], inp["pp_x"]
        mine = (ws[rank:rank + 1], bs[rank:rank + 1])
        out["gpipe"] = pipeline_parallel.make_gpipe_fn(mesh_pp4, _stage, xp.shape[0])(mine, xp)
        out["gpipe_one"] = pipeline_parallel.make_gpipe_fn(mesh_pp4, _stage, 1)(
            (inp["pp1_w"][rank:rank + 1], inp["pp1_b"][rank:rank + 1]), inp["pp1_x"])
        xg, tg = inp["ppg_x"], inp["ppg_t"]
        leaves = [ws[rank:rank + 1].clone().requires_grad_(),
                  bs[rank:rank + 1].clone().requires_grad_()]
        gp = pipeline_parallel.make_gpipe_fn(mesh_pp4, _stage, xg.shape[0])
        _half_sse(gp(tuple(leaves), xg), tg).backward()
        out["gpipe_grads"] = [p.grad.clone() for p in leaves]
        params = tuple(t[rank:rank + 1].clone() for t in inp["ppl_params"])
        step = pipeline_parallel.make_gpipe_train_step(mesh_pp4, _stage, _mse, 4)
        learn = []
        for _ in range(30):
            loss, grads = step(params, inp["ppl_x"], inp["ppl_y"])
            learn.append(float(loss))
            params = tuple(p - 5e-2 * g for p, g in zip(params, grads))
        out["gpipe_learn"] = learn

        # the real encoder through two stages, ranks 0 and 1
        out["error_pp4"] = _error(lambda: pipeline_parallel.make_gpipe_real_encoder_fn(
            ENC, mesh_pp4, ConvEncoder(ENC, device="cpu"), 2, 256, 3))
        out["error_blocks"] = _error(lambda: pipeline_parallel.make_gpipe_real_encoder_fn(
            ONE_BLOCK, mesh_pp2, ConvEncoder(ONE_BLOCK, device="cpu"), 2, 256, 3))
        if rank < 2:
            enc = encoder_of(ENC, inp["ppr_eval_vars"])
            xr = inp["ppr_eval_x"]
            M, mb = xr.shape[:2]
            fn, pack = pipeline_parallel.make_gpipe_real_encoder_fn(ENC, mesh_pp2, enc, mb,
                                                                    xr.shape[2], M)
            out["ppr_eval"] = fn(pack(enc), xr)
            out["ppr_eval_own"] = torch.stack([fast_embed(enc, xr[t]) for t in range(M)])

            enc = encoder_of(ENC, inp["ppr_train_vars"])
            xr, yr = inp["ppr_train_x"], inp["ppr_train_y"]
            M, mb = xr.shape[:2]
            step, pack, _ = pipeline_parallel.make_gpipe_real_train_step(
                ENC, mesh_pp2, enc, mb, xr.shape[2], M, _mse)
            loss, grads, _ = step(pack(enc), xr, yr)
            enc.train()
            seq_loss = _mse(torch.stack([enc(xr[t]) for t in range(M)]), yr)
            seq_loss.backward()
            out["ppr_train"] = (float(loss), grads, float(seq_loss),
                                _pack_grads(ENC, grads_of(enc), pack))

            enc = encoder_of(ENC, inp["ppr_bn_vars"])
            xr = inp["ppr_bn_x"]
            M, mb = xr.shape[:2]
            fn, pack, apply_stats = pipeline_parallel.make_gpipe_real_encoder_fn(
                ENC, mesh_pp2, enc, mb, xr.shape[2], M, train=True)
            got, stats = fn(pack(enc), xr)
            new = apply_stats(enc, stats)
            enc.train()
            with torch.no_grad():
                outs = torch.stack([enc(xr[t]) for t in range(M)])
            out["ppr_bn"] = (got.detach(), comm.tree_flatten(new)[0], outs,
                             [b.clone() for b in comm.tree_flatten(
                                 {f"block_{i}": {"bn": {"mean": blk.bn.running_mean,
                                                        "var": blk.bn.running_var}}
                                  for i, blk in enumerate(enc.blocks)})[0]])

        out["dryrun"] = dryrun.dryrun_rank(rank, world, "cpu")
        out["staged"] = dict(comm.STAGED)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _init(model, x, seed, bn_seed):
    return randomize_bn(model.init(jax.random.PRNGKey(seed), x, train=False), bn_seed)


@pytest.fixture(scope="module")
def inputs():
    """Every case's inputs: numpy draws and flax inits (numpy trees)."""
    r = np.random.default_rng(0)
    f32 = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    jenc, jdil = JaxEncoder(jax_config(ENC)), JaxEncoder(jax_config(DIL))
    x_h = np.random.default_rng(3).standard_normal((2, 2048, 1)).astype(np.float32)
    x_d = np.random.default_rng(4).standard_normal((1, 1024, 1)).astype(np.float32)
    x_tp = np.random.default_rng(13).standard_normal((8, 1024, 1)).astype(np.float32)
    rdp = np.random.default_rng(6)
    x_dp = rdp.standard_normal((DPSP_B, DPSP_T, 1)).astype(np.float32)
    y_dp = rdp.integers(0, SPEAKERS, DPSP_B).astype(np.int32)
    jclf = JaxClassifier(jax_config(DIL), num_classes=SPEAKERS)
    z = jnp.zeros((1, DPSP_T, 1))
    eye = np.eye(8, dtype=np.float32)
    ppl = (eye[None] + f32(4, 8, 8, scale=0.05), np.full((4, 8), 0.1, np.float32))
    rr = np.random.default_rng(3)
    x_re = rr.standard_normal((4, 2, 512, 1)).astype(np.float32)
    rt = np.random.default_rng(4)
    x_rt = rt.standard_normal((3, 2, 256, 1)).astype(np.float32)
    y_rt = rt.standard_normal((3, 2, ENC.embedding_dim)).astype(np.float32)
    x_rb = np.random.default_rng(5).standard_normal((3, 2, 256, 1)).astype(np.float32)
    return dict(
        comm_x=f32(4, 3, 5), comm_ct=f32(4, 3, 5), comm_ctg=f32(4, 12, 5),
        halo_x=x_h, halo_vars=to_numpy(_init(jenc, x_h, 0, 5)),
        halo_dil_x=x_d, halo_dil_vars=to_numpy(_init(jdil, x_d, 0, 6)),
        dpsp_x=x_dp, dpsp_y=y_dp, dpsp_vars=to_numpy(_init(jclf, z, 0, 7)),
        step_vars=to_numpy(_init(jclf, z, 1, 8)),
        tp_x=x_tp, tp_vars=to_numpy(_init(jenc, x_tp[:1], 0, 9)),
        head=(f32(4, 32), f32(32, 64), f32(64)), head_2d=(f32(2, 8), f32(8, 16), f32(16)),
        mlp=(f32(4, 16), f32(16, 64), f32(64), f32(64, 24), f32(24)),
        pp_w=f32(4, D_PP, D_PP, scale=0.3), pp_b=f32(4, D_PP, scale=0.1),
        pp_x=f32(6, MB_PP, D_PP), pp1_w=f32(4, 8, 8, scale=0.3),
        pp1_b=np.zeros((4, 8), np.float32), pp1_x=f32(1, 2, 8),
        ppg_x=f32(5, MB_PP, D_PP), ppg_t=f32(5, MB_PP, D_PP),
        ppl_params=ppl, ppl_x=f32(4, 4, 8), ppl_y=np.abs(f32(4, 4, 8)),
        ppr_eval_x=x_re, ppr_eval_vars=to_numpy(_init(jenc, x_re[0], 0, 10)),
        ppr_train_x=x_rt, ppr_train_y=y_rt,
        ppr_train_vars=to_numpy(_init(jenc, x_rt[0], 1, 11)),
        ppr_bn_x=x_rb, ppr_bn_vars=to_numpy(_init(jenc, x_rb[0], 2, 12)),
    )


def _torch_tree(v):
    if isinstance(v, dict):
        return {k: _torch_tree(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_torch_tree(x) for x in v)
    if isinstance(v, np.ndarray) and v.dtype != np.float32:
        return torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
    return torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v


def _mesh(**sizes):
    return jmesh.make_mesh(sizes)


def _jax_stage(params, x):
    w, b = params
    return jax.nn.relu(x @ w + b)


def _jax_side(inputs) -> dict:
    """Every JAX result the tests hold the ranks against, computed here while
    the ranks run."""
    want = {}

    def dev(x, ct_s, ct_g):
        x = x[0]
        res = []
        for f, ct in ((lambda v: jax.lax.ppermute(v, "i", [(i, i + 1) for i in range(3)]),
                       ct_s), (lambda v: jax.lax.all_gather(v, "i", axis=0, tiled=True), ct_g),
                      (lambda v: jax.lax.psum(v, "i"), ct_s),
                      (lambda v: jax.lax.pmean(v, "i"), ct_s)):
            y, vjp = jax.vjp(f, x)
            res += [y[None], vjp(ct[0])[0][None]]
        return tuple(res)

    f = jax.jit(jax.shard_map(dev, mesh=_mesh(i=4), in_specs=(P("i"),) * 3,
                              out_specs=(P("i"),) * 8, check_vma=False))
    want["comm"] = [np.asarray(a) for a in f(inputs["comm_x"], inputs["comm_ct"],
                                             inputs["comm_ctg"])]

    for case, cfg in (("halo", jax_config(ENC)), ("halo_dil", jax_config(DIL))):
        v, x = inputs[f"{case}_vars"], inputs[f"{case}_x"]
        want[case] = (
            np.asarray(jhalo.make_sharded_embed_fn(cfg, _mesh(seq=4), axis="seq")(v, x)),
            np.asarray(JaxEncoder(cfg).apply(v, x, train=False)))
    v, x = inputs["halo_vars"], inputs["halo_x"]
    model = JaxEncoder(jax_config(ENC))
    want["halo_grads"] = jax.grad(lambda p: jnp.sum(model.apply(
        {"params": p, "batch_stats": v["batch_stats"]}, x, train=False) ** 2))(v["params"])

    cfg = jax_config(step_cfg())
    model = JaxClassifier(cfg.encoder, num_classes=SPEAKERS)
    v, x, y = inputs["dpsp_vars"], inputs["dpsp_x"], inputs["dpsp_y"]
    key = jax.random.PRNGKey(2)
    (ref_loss, (ref_bs, _)), g_ref = jax.value_and_grad(
        jsteps.classifier_loss_fn(model), has_aux=True)(v["params"], v["batch_stats"], x, y, key)
    sharded = jdp_sp.dp_sp_classifier_loss_fn(cfg, "data", "seq")

    def device_grads(params, bs, x_local, y_local):
        (loss, _), g = jax.value_and_grad(sharded, has_aux=True)(params, bs, x_local,
                                                                 y_local, key)
        for ax in ("seq", "data"):
            g = jax.tree.map(lambda t: jax.lax.pmean(t, ax), g)
            loss = jax.lax.pmean(loss, ax)
        return loss, g

    loss_2d, g_2d = jax.jit(jax.shard_map(
        device_grads, mesh=_mesh(data=2, seq=2),
        in_specs=(P(), P(), P("data", "seq", None), P("data")), out_specs=(P(), P()),
        check_vma=False))(v["params"], v["batch_stats"], x, y)
    want["dpsp"] = (float(ref_loss), g_ref, float(loss_2d), g_2d,
                    comm.tree_flatten(to_numpy(ref_bs))[0])

    v, x = inputs["tp_vars"], inputs["tp_x"]
    cfg = jax_config(ENC)
    want["tp_embed"] = (
        np.asarray(jtp.make_tp_encoder_embed_fn(cfg, _mesh(data=2, model=2))(v, x)),
        np.asarray(JaxEncoder(cfg).apply(v, x, train=False)))
    want["tp_head"] = np.asarray(jtp.make_tp_embed_head(_mesh(model=4), "model")(
        *inputs["head"]))
    want["tp_head_2d"] = np.asarray(jtp.make_tp_embed_head(_mesh(data=2, model=2), "model")(
        *inputs["head_2d"]))
    want["tp_mlp"] = np.asarray(jtp.make_tp_mlp(_mesh(model=4), "model")(*inputs["mlp"]))

    for name, w, b, x in (("gpipe", inputs["pp_w"], inputs["pp_b"], inputs["pp_x"]),
                          ("gpipe_one", inputs["pp1_w"], inputs["pp1_b"], inputs["pp1_x"])):
        want[name] = np.asarray(jpp.make_gpipe_fn(_mesh(pp=4), _jax_stage, x.shape[0])(
            (w, b), x))
    ws, bs, x, tgt = inputs["pp_w"], inputs["pp_b"], inputs["ppg_x"], inputs["ppg_t"]
    pp = jpp.make_gpipe_fn(_mesh(pp=4), _jax_stage, x.shape[0])
    want["gpipe_grads"] = jax.grad(lambda p: 0.5 * jnp.sum((pp(p, x) - tgt) ** 2))((ws, bs))

    cfg, mesh = jax_config(ENC), _mesh(pp=2)
    v, x = inputs["ppr_eval_vars"], inputs["ppr_eval_x"]
    M, mb, T = x.shape[:3]
    fn, pack = jpp.make_gpipe_real_encoder_fn(cfg, mesh, v, mb, T, M)
    want["ppr_eval"] = (np.asarray(fn(pack(v), x)), np.asarray(jax_fast_embed(
        v, cfg, x.reshape(M * mb, T, 1))).reshape(M, mb, -1))
    v, x, y = inputs["ppr_train_vars"], inputs["ppr_train_x"], inputs["ppr_train_y"]
    M, mb, T = x.shape[:3]
    step, pack, _ = jpp.make_gpipe_real_train_step(
        cfg, mesh, v, mb, T, M, lambda o, t: jnp.mean((o - t) ** 2))
    loss, grads, _ = step(pack(v), x, y)
    want["ppr_train"] = (float(loss), np.asarray(grads))
    v, x = inputs["ppr_bn_vars"], inputs["ppr_bn_x"]
    M, mb, T = x.shape[:3]
    fn, pack, apply_stats = jpp.make_gpipe_real_encoder_fn(cfg, mesh, v, mb, T, M, train=True)
    out, stats = fn(pack(v), x)
    want["ppr_bn"] = (np.asarray(out), comm.tree_flatten(to_numpy(apply_stats(v, stats)))[0])

    errors = {}
    for name, call in (
            ("batch", lambda: jdp_sp.make_dp_sp_classifier_train_step(
                jax_config(step_cfg(batch=5)), _mesh(data=2, seq=2))),
            ("length", lambda: jdp_sp.make_dp_sp_classifier_train_step(
                jax_config(step_cfg(seconds=0.25625)), _mesh(data=2, seq=2))),
            ("pp4", lambda: jpp.make_gpipe_real_encoder_fn(
                jax_config(ENC), _mesh(pp=4), inputs["ppr_bn_vars"], 2, 256, 3)),
            ("blocks", lambda: jpp.make_gpipe_real_encoder_fn(
                jax_config(ONE_BLOCK), _mesh(pp=2), JaxEncoder(jax_config(ONE_BLOCK)).init(
                    jax.random.PRNGKey(0), jnp.zeros((1, 256, 1)), train=False), 2, 256, 3)),
            # a shard that does not divide a block's pool fails in JAX's reshape
            ("halo_pool", lambda: jhalo.make_sharded_embed_fn(
                jax_config(ENC), _mesh(seq=4), axis="seq")(inputs["halo_vars"],
                                                           inputs["halo_x"][:, :160])),
            # a model axis that does not divide the hidden width fails in in_specs
            ("tp", lambda: jtp.make_tp_mlp(_mesh(model=4), "model")(
                *_narrow_mlp(inputs["mlp"])))):
        try:
            call()
            errors[name] = None
        except Exception as e:  # noqa: BLE001 - JAX's own exception types
            errors[name] = e
    want["errors"] = errors
    return want


def _narrow_mlp(mlp):
    """The MLP's weights at a hidden width of 6, which 4 ranks do not divide."""
    x, w1, b1, w2, b2 = mlp
    return x, w1[:, :6], b1[:6], w2[:6], b2


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    """Every rank's results of one world-4 run on gloo, and the JAX side's,
    computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("layers_ranks")
    torch.save({k: (v if k.endswith("_vars") else _torch_tree(v)) for k, v in inputs.items()},
               tmp / "inputs.pt")
    box = {}
    spawn(_layers_rank, WORLD, tmp, timeout=300.0,
          meanwhile=lambda: box.update(want=_jax_side(inputs)))
    return ([torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)],
            box["want"])


@pytest.fixture(scope="module")
def ranks(run):
    return run[0]


@pytest.fixture(scope="module")
def want(run):
    return run[1]


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _grads_close(got: dict, want_flax: dict, cfg, tol: dict):
    """Port gradients (by parameter name) against a flax gradient tree."""
    got_flax = to_flax(got, cfg)["params"]
    flat_got, _ = comm.tree_flatten(got_flax)
    flat_want, _ = comm.tree_flatten(to_numpy(want_flax))
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        _close(a, b, **tol)


def test_the_collectives_backwards_are_jaxs_transposes(ranks, want):
    for r, got in enumerate(ranks):
        for j, name in enumerate(("shift", "gather", "psum", "pmean")):
            y, g = got[f"comm_{name}"]
            _close(y, want["comm"][2 * j][r], COMM_TOL, COMM_TOL, name)
            _close(g, want["comm"][2 * j + 1][r], COMM_TOL, COMM_TOL, f"{name} backward")


@pytest.mark.parametrize("case", ["halo", "halo_dil"])
def test_the_halo_encoder_matches_jax_and_the_dense_forward(ranks, want, case):
    sharded, dense = want[case]
    for got in ranks:
        _close(got[case], sharded, FWD_TOL, FWD_TOL)
        _close(got[case], dense, FWD_TOL, FWD_TOL)


def test_the_halo_gradients_match_the_dense_gradients(ranks, want):
    for got in ranks:
        _grads_close(got["halo_grads"], want["halo_grads"], ENC, HALO_GRAD)
        for k, g in got["halo_dense_grads"].items():
            _close(got["halo_grads"][k], g, **OWN_GRAD, msg=k)
        _close(got["halo"], got["halo_dense"], FWD_TOL, FWD_TOL)


def test_data_x_seq_gradients_equal_the_single_device_full_batch(ranks, want):
    """{data 2, seq 2} at dropout 0: the port's averaged gradients against
    the JAX single-device loss, the JAX 2-D step's and the port's own
    single-device full-batch forward."""
    ref_loss, g_ref, loss_2d, g_2d, want_stats = want["dpsp"]
    own_loss, own_grads, own_stats = ranks[0]["dpsp_ref"]
    for got in ranks:
        assert got["dpsp_loss"] == pytest.approx(ref_loss, rel=LOSS_RTOL)
        assert got["dpsp_loss"] == pytest.approx(loss_2d, rel=LOSS_RTOL)
        assert got["dpsp_loss"] == pytest.approx(own_loss, rel=LOSS_RTOL)
        _grads_close(got["dpsp_grads"], g_ref, DIL, DPSP_JAX)
        _grads_close(got["dpsp_grads"], g_2d, DIL, DPSP_JAX)
        for k, g in own_grads.items():
            _close(got["dpsp_grads"][k], g, **OWN_GRAD, msg=k)
        for a, b, c in zip(got["dpsp_stats"], own_stats, want_stats):
            _close(a, b, STATS_TOL, STATS_TOL)
            _close(a, c, STATS_TOL, STATS_TOL)


def test_the_data_x_seq_step_is_the_single_device_step_and_trains(ranks):
    """One step on the draws of the two data rows against the port's
    single-device step on their concatenation; then the step trains."""
    ref_loss, ref_grads, ref_buffers, blockn, fused0 = ranks[0]["step_ref"]
    assert (blockn, fused0) == ("jnp", False)  # the autograd blocks, as the halo forward
    for got in ranks:
        g_loss, g_grads, g_buffers = got["step_one"]
        assert g_loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
        for k, g in ref_grads.items():
            _close(g_grads[k], g, **OWN_GRAD, msg=k)
        for k, b in ref_buffers.items():
            _close(g_buffers[k], b, STATS_TOL, STATS_TOL, k)
        for k, p in ranks[0]["step_params"].items():  # the same state on every rank
            assert torch.equal(got["step_params"][k], p), k
    hist = ranks[0]["step_losses"]
    assert len(hist) == STEP_COUNT and np.isfinite(hist).all()
    assert np.mean(hist[-5:]) < np.mean(hist[:5]), hist


def test_the_dropout_mask_is_shared_by_a_data_row_and_not_across_rows(ranks):
    masks = [r["masks"] for r in ranks]
    assert len(masks[0]) == len(DIL.filter_multipliers)
    for b in range(len(masks[0])):
        m = [x[b] for x in masks]
        assert torch.equal(m[0], m[1]) and torch.equal(m[2], m[3])  # seq ranks of a row
        assert not torch.equal(m[0], m[2])  # the two data rows
        assert 0 < float(m[0].float().mean()) < 1


def test_the_tp_real_encoder_embed_matches_jax_and_apply(ranks, want):
    tp, dense = want["tp_embed"]
    for r, got in enumerate(ranks):
        rows = slice(4 * (r // 2), 4 * (r // 2) + 4)
        _close(got["tp_embed"], tp[rows], FWD_TOL, FWD_TOL)
        _close(got["tp_embed"], dense[rows], FWD_TOL, FWD_TOL)


def test_the_tp_embed_heads_match_the_dense_product_and_jax(ranks, inputs, want):
    x, w, b = inputs["head"]
    x2, w2, b2 = inputs["head_2d"]
    for got in ranks:
        _close(got["tp_head"].detach(), x @ w + b, FWD_TOL, FWD_TOL)
        _close(got["tp_head"].detach(), want["tp_head"], FWD_TOL, FWD_TOL)
        _close(got["tp_head_2d"].detach(), x2 @ w2 + b2, FWD_TOL, FWD_TOL)
        _close(got["tp_head_2d"].detach(), want["tp_head_2d"], FWD_TOL, FWD_TOL)


def test_the_tp_mlp_matches_the_dense_block_and_its_gradients(ranks, inputs, want):
    dense_in = [torch.from_numpy(t).requires_grad_() for t in inputs["mlp"]]
    xt, w1t, b1t, w2t, b2t = dense_in
    y = torch.relu(xt @ w1t + b1t) @ w2t + b2t
    (y ** 2).sum().backward()
    for got in ranks:
        y_got, g_got = got["tp_mlp"]
        _close(y_got, want["tp_mlp"], FWD_TOL, FWD_TOL)
        _close(y_got, y.detach(), FWD_TOL, FWD_TOL)
        for a, t in zip(g_got, dense_in):
            _close(a, t.grad, FWD_TOL, FWD_TOL)


def test_gpipe_matches_sequential_and_jax(ranks, inputs, want):
    for name, w, b, x in (("gpipe", inputs["pp_w"], inputs["pp_b"], inputs["pp_x"]),
                          ("gpipe_one", inputs["pp1_w"], inputs["pp1_b"], inputs["pp1_x"])):
        seq = x
        for s in range(4):
            seq = np.maximum(seq @ w[s] + b[s], 0.0)
        for got in ranks:
            _close(got[name], want[name], GPIPE_TOL, GPIPE_TOL, name)
            _close(got[name], seq, GPIPE_TOL, GPIPE_TOL, name)


def test_gpipe_gradients_match_sequential_and_jax(ranks, inputs, want):
    ws, bs, x, tgt = (torch.from_numpy(inputs[k]) for k in ("pp_w", "pp_b", "ppg_x", "ppg_t"))
    ws.requires_grad_(), bs.requires_grad_()
    y = x
    for s in range(4):
        y = torch.relu(y @ ws[s] + bs[s])
    _half_sse(y, tgt).backward()
    for r, got in enumerate(ranks):
        for j, g_seq in enumerate((ws.grad, bs.grad)):
            _close(got["gpipe_grads"][j][0], want["gpipe_grads"][j][r], GPIPE_TOL, GPIPE_TOL)
            _close(got["gpipe_grads"][j][0], g_seq[r], GPIPE_TOL, GPIPE_TOL)


def test_the_gpipe_train_step_learns(ranks):
    losses_ = ranks[0]["gpipe_learn"]
    assert losses_[-1] < losses_[0] * 0.5, losses_
    assert all(r["gpipe_learn"] == losses_ for r in ranks)


def test_the_real_encoder_pipeline_eval_matches_jax_and_fast_embed(ranks, want):
    pipe, seq = want["ppr_eval"]
    for got in ranks[:2]:
        _close(got["ppr_eval"], pipe, FWD_TOL, FWD_TOL)
        _close(got["ppr_eval"], seq, FWD_TOL, FWD_TOL)
        _close(got["ppr_eval"], got["ppr_eval_own"], OWN_EVAL, OWN_EVAL)
    assert "ppr_eval" not in ranks[2] and "ppr_eval" not in ranks[3]


def test_the_real_encoder_pipeline_gradients_match_sequential_train_mode(ranks, want):
    loss, grads = want["ppr_train"]
    for r, got in enumerate(ranks[:2]):
        g_loss, g_row, seq_loss, seq_row = got["ppr_train"]
        assert g_loss == pytest.approx(loss, rel=LOSS_RTOL)
        assert g_loss == pytest.approx(seq_loss, rel=LOSS_RTOL)
        assert g_row.shape == (1, grads.shape[1])
        _close(g_row[0], grads[r], **REAL_GRAD)
        _close(g_row, seq_row, **REAL_GRAD)
        assert float(g_row.abs().max()) > 0.0


def test_the_real_encoder_pipelines_running_statistics_chain_the_microbatches(ranks, want):
    out, stats = want["ppr_bn"]
    for got in ranks[:2]:
        g_out, g_stats, seq_out, seq_stats = got["ppr_bn"]
        _close(g_out, out, FWD_TOL, FWD_TOL)
        _close(g_out, seq_out, FWD_TOL, FWD_TOL)
        for a, b, c in zip(g_stats, seq_stats, stats):
            _close(a, b, **CHAIN)
            _close(a, c, **CHAIN)


def test_the_refusals_are_jaxs(ranks, want):
    errors = want["errors"]
    for name in ("batch", "length", "pp4", "blocks"):
        assert isinstance(errors[name], ValueError), name
    assert errors["halo_pool"] is not None and errors["tp"] is not None
    for got in ranks:
        for name in ("batch", "length", "pp4", "blocks"):
            assert got[f"error_{name}"] == f"ValueError: {errors[name]}", name
        assert got["error_halo_pool"].startswith("ValueError: block_2:")
        assert got["error_tp"].startswith("ValueError: dimension 1 of size 6")


def test_the_dryruns_fields_are_jaxs(ranks):
    """``dryrun_rank``'s nine fields by name and order are those of the JAX
    dry run's last record, and at n = 4 each is finite or of the shape the
    JAX dry run gives at n = 4."""
    tail = json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]
    names = re.findall(r"(dp|sp|ring|tp|pp-bwd|pp-real|pp|dp_sp|dp-stream)"
                       r"(?: loss| embed shape| distance| block| out)", tail)
    assert tuple(names) == dryrun.FIELDS
    n = WORLD
    want_shapes = {"sp": (2, 16), "ring": (2 * n, 4 * n), "tp": (4, 8), "pp": (4, 2, 8)}
    for got in ranks:
        fields = got["dryrun"]
        assert tuple(fields) == dryrun.FIELDS
        for k, v in fields.items():
            if k in want_shapes:
                assert v == want_shapes[k], k
            else:
                assert np.isfinite(v), k
        assert fields == ranks[0]["dryrun"]
    line = dryrun.line(n, ranks[0]["dryrun"])
    assert re.sub(r"=\d+\.\d{4}", "=x", line) == re.sub(
        r"=\d+\.\d{4}", "=x", tail.strip().replace("8 devices", "4 devices")
        .replace("(16, 32)", "(8, 16)"))
    assert all(r["staged"]["bytes"] == 0 for r in ranks)  # on the CPU nothing is staged
