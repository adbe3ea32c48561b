"""Data-parallel training on the port (``voicemap_tpu_torch/parallel/
data_parallel.py``, ``fit(dp=)``, ``parallel/distributed.py``) at world
size 2 on gloo, on the CPU.

One process group serves the module: ``ranks`` spawns two processes once
(``test_torch_pod_eval.spawn``), each runs every case below and saves what
it got, and the tests read the files. Tolerances, each with its reason:

- a DP step against the port's own single-process computation (each rank's
  sub-batch through the single-device loss, its own BatchNorm batch
  statistics, the gradients and updated buffers averaged, one update):
  f32 1e-6 relative (the same arithmetic but for the order of a two-term
  sum);
- the streaming DP steps against the JAX package's
  ``make_dp_streaming_{classifier,siamese}_step`` on a 2-device mesh of the
  faked CPU devices: 1e-4 (``test_torch_streaming``'s tolerance for the
  single-device streaming step: the frameworks' convs, reductions and Adam
  sum in other orders); the clipped averaged gradient against the JAX
  loss's per-shard gradients, averaged, then clipped by optax: 1e-4 of the
  largest entry (the sums' rounding scales with their largest terms);
- ``fit(dp="on")``: the ranks' parameters bitwise equal.

Every step case runs with the clip idle (``clipnorm`` 1e3) and active
(``clipnorm`` below the averaged gradient's global norm, which the tests
assert): the gradient is averaged over the ranks, then clipped.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from test_torch_pod_eval import spawn
from test_torch_train_forward import assert_tree_close
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.models.siamese import SiameseNet as JaxSiamese
from voicemap_tpu.parallel import data_parallel as jdp
from voicemap_tpu.parallel import distributed as jdistributed
from voicemap_tpu.parallel import mesh as jmesh
from voicemap_tpu.train import state as jstate
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.ops import sampling
from voicemap_tpu_torch.parallel import data_parallel, distributed
from voicemap_tpu_torch.parallel.mesh import data_mesh
from voicemap_tpu_torch.train import steps
from voicemap_tpu_torch.train.loop import fit, use_data_parallel
from voicemap_tpu_torch.train.state import apply_updates, init_state

WORLD = 2
BATCH = 8
SPEAKERS, UTTS = 4, 4
OWN_RTOL = 1e-6
JAX_TOL = 1e-4
STEP_SEED = 123
FIT_STEPS, FIT_EVERY = 4, 2
ZERO_GRAD = 1e-6  # of the largest gradient entry: zero but for rounding
# clipnorm idle, and below the averaged gradient's global norm (asserted)
CLIPS = {"idle": 1e3, "active": 0.05}


def experiment(mode="classifier", batch=BATCH, clip="idle", **train):
    return ExperimentConfig(
        mode=mode, data=DataConfig(seconds=0.25, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, compute_dtype="float32"),
        siamese=SiameseConfig(distance_metric="weighted_l1"),
        train=TrainConfig(batch_size=batch, clipnorm=CLIPS[clip], **train))


def host_store():
    return synthetic_store(5, n_speakers=SPEAKERS, utterances_per_speaker=UTTS,
                           min_seconds=0.3, max_seconds=0.5)


def port_model(mode, state_dict):
    cfg = experiment(mode)
    model = (SiameseNet(cfg.encoder, cfg.siamese, device="cpu") if mode == "siamese"
             else SpeakerClassifier(cfg.encoder, SPEAKERS, device="cpu"))
    model.load_state_dict(state_dict)
    return model


def _snapshot(model, state):
    """A rank's model after a step: state dict, gradients, metrics."""
    return {"state": {k: v.clone() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None}}


def own_reference(mode, weights, store, cfg):
    """One DP step by hand in one process: each rank's draws (its generator
    from ``rank_generator``) through the single-device loss on a fresh copy
    of the weights, the gradients, buffers and metrics averaged, then one
    update of a fresh copy with those gradients and buffers (clipped there,
    after the mean)."""
    local_B = cfg.train.batch_size // WORLD
    grads, buffers, metrics = [], [], []
    for r in range(WORLD):
        model = port_model(mode, weights)
        gen = steps.rank_generator(torch.Generator().manual_seed(STEP_SEED), r)
        if mode == "siamese":
            loss_fn = steps.siamese_loss_fn(model, cfg)
            b = sampling.sample_verification_batch(gen, store.speaker_utts,
                                                   store.speaker_counts, local_B, 0)
            x1 = steps.fetch_batch(store, b.idx_1, cfg, gen, cfg.data.stochastic)
            x2 = steps.fetch_batch(store, b.idx_2, cfg, gen, cfg.data.stochastic)
            loss, acc = loss_fn(x1, x2, b.labels, gen)
        else:
            loss_fn = steps.classifier_loss_fn(model, cfg)
            idx = sampling.sample_classifier_batch(gen, store.labels.shape[0], local_B)
            x = steps.fetch_batch(store, idx, cfg, gen, cfg.data.stochastic)
            loss, acc = loss_fn(x, store.labels[idx], gen)
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
        buffers.append({k: b.clone() for k, b in model.named_buffers()
                        if b.is_floating_point()})
        metrics.append((float(loss.detach()), float(acc)))
    model = port_model(mode, weights)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k in grads[0]:
                p.grad = (grads[0][k] + grads[1][k]) / 2
        for k, b in model.named_buffers():
            if k in buffers[0]:
                b.copy_((buffers[0][k] + buffers[1][k]) / 2)
    norm = float(torch.sqrt(sum(p.grad.square().sum() for p in model.parameters()
                                if p.grad is not None)))
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    apply_updates(state)
    return {**_snapshot(model, state), "norm": norm,
            "loss": np.mean([m[0] for m in metrics]),
            "accuracy": np.mean([m[1] for m in metrics]),
            "local_grads_differ": any(not torch.equal(g, grads[1][k])
                                      for k, g in grads[0].items())}


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _dp_rank(rank: int, world: int, rendezvous: str, tmp: str) -> None:
    """One rank: every case of the module, its results saved to rank<r>.pt."""
    torch.set_num_threads(1)
    out = {"initialized": distributed.initialize(rendezvous, world, rank, device="cpu")}
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        host = host_store()
        mesh = data_mesh()
        for mode in ("classifier", "siamese"):
            for clip in CLIPS:
                cfg = experiment(mode, clip=clip)
                store = steps.device_store_for(cfg, host, "cpu")
                model = port_model(mode, inputs["weights"][mode])
                make = (data_parallel.make_dp_siamese_train_step if mode == "siamese"
                        else data_parallel.make_dp_classifier_train_step)
                step, _ = make(model, cfg, mesh)
                state, m = step(init_state(model, cfg.train.clipnorm, cfg.train.learning_rate),
                                store, torch.Generator().manual_seed(STEP_SEED))
                out[f"own_{mode}_{clip}"] = {**_snapshot(model, state), "loss": float(m["loss"]),
                                             "accuracy": float(m["accuracy"]),
                                             "step": state.step}
                if rank == 0:
                    out[f"own_{mode}_{clip}_reference"] = own_reference(
                        mode, inputs["weights"][mode], store, cfg)
                # the streaming step on the host batch the parent cut
                make = (data_parallel.make_dp_streaming_siamese_step if mode == "siamese"
                        else data_parallel.make_dp_streaming_classifier_step)
                model = port_model(mode, inputs["weights"][mode])
                step, _ = make(model, cfg, mesh)
                state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
                state, m = step(state, *inputs["stream"][mode], None)
                out[f"stream_{mode}_{clip}"] = {**_snapshot(model, state),
                                                "loss": float(m["loss"]),
                                                "accuracy": float(m["accuracy"])}

        out["error_batch"] = _error(lambda: data_parallel.make_dp_classifier_train_step(
            port_model("classifier", inputs["weights"]["classifier"]),
            experiment(batch=7), mesh))
        # fit(dp="on") on every rank: one log, one checkpoint directory
        cfg = experiment(num_steps=FIT_STEPS, evaluate_every=FIT_EVERY, num_eval_tasks=20,
                         k_way=3, log_path=os.path.join(tmp, "fit.jsonl"),
                         checkpoint_dir=os.path.join(tmp, "ckpt"))
        state, history = fit(cfg, host, device="cpu", verbose=False, dp="on")
        out["fit"] = {"state": state.model.state_dict(), "history": history,
                      "step": state.step}
        out["fit_error"] = _error(lambda: fit(
            experiment(batch=7, num_steps=1), host, device="cpu", verbose=False, dp="on"))

        out["global"] = distributed.global_mesh().mesh.tolist()
        out["global_2d"] = distributed.global_mesh({"data": 2, "model": 1}).mesh.tolist()
        out["hybrid"] = distributed.global_mesh({"data": 1}, {"data": 2}).mesh.tolist()
        out["error_cover"] = _error(lambda: distributed.global_mesh({"data": 3}))
        out["error_hybrid"] = _error(lambda: distributed.global_mesh({"data": 2}, {"data": 2}))
        out["error_dcn_axis"] = _error(lambda: distributed.global_mesh({"data": 2},
                                                                       {"model": 1}))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def jax_pair(mode):
    """The JAX model, config and flax variables of ``mode``, BatchNorm
    randomized (so the buffers' mean is tested), the siamese head's bias set."""
    jcfg = jax_config(experiment(mode))
    x = jnp.zeros((1, jcfg.data.model_length, 1))
    if mode == "siamese":
        jmodel = JaxSiamese(jcfg.encoder, jcfg.siamese)
        variables = randomize_bn(jmodel.init(jax.random.PRNGKey(7), x, x), 8)
        variables["params"]["head"]["bias"] = np.array([0.25], np.float32)
    else:
        jmodel = JaxClassifier(jcfg.encoder, num_classes=SPEAKERS)
        variables = randomize_bn(jmodel.init(jax.random.PRNGKey(6), x), 7)
    return jmodel, jcfg, variables


@pytest.fixture(scope="module")
def jax_side():
    rng = np.random.default_rng(17)
    frag = experiment().data.fragment_length
    side = {"models": {m: jax_pair(m) for m in ("classifier", "siamese")}}
    side["weights"] = {m: from_flax(v, experiment(m).encoder)
                       for m, (_, _, v) in side["models"].items()}
    side["stream"] = {
        "classifier": (rng.integers(-2000, 2000, (BATCH, frag)).astype(np.int16),
                       rng.integers(0, SPEAKERS, BATCH).astype(np.int32)),
        "siamese": (rng.integers(-2000, 2000, (BATCH, frag)).astype(np.int16),
                    rng.integers(-2000, 2000, (BATCH, frag)).astype(np.int16),
                    np.repeat(np.array([0.0, 1.0], np.float32), BATCH // 2)),
    }
    return side


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every rank's results of one world-2 run on gloo, and the run's directory."""
    tmp = tmp_path_factory.mktemp("dp_ranks")
    torch.save({"weights": jax_side["weights"], "stream": jax_side["stream"]},
               tmp / "inputs.pt")
    spawn(_dp_rank, WORLD, tmp)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], tmp


@pytest.fixture(scope="module")
def mesh2():
    return jmesh.make_mesh({"data": WORLD})


def _close(got: dict, want: dict, rtol: float, atol: float = 0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


# the clip idle keeps the bare mode as the case's id
MODES_CLIPS = [pytest.param(mode, clip, id=mode if clip == "idle" else f"{mode}-clip-{clip}")
               for clip in CLIPS for mode in ("classifier", "siamese")]


@pytest.mark.parametrize("mode,clip", MODES_CLIPS)
def test_a_dp_step_is_the_average_of_the_sub_batch_steps(ranks, mode, clip):
    """The mean of the per-rank gradients, each on its own sub-batch with its
    own BatchNorm statistics, clipped after the mean and applied once; the
    buffers the mean of the ranks' updated buffers (mirrors the JAX
    package's ``test_dp_grads_match_shardwise_average``). With the clip
    active, a step that clipped each rank's gradient before the mean would
    miss the reference's clipped gradient."""
    results, _ = ranks
    want = results[0][f"own_{mode}_{clip}_reference"]
    assert (want["norm"] > CLIPS[clip]) is (clip == "active")
    for got in (r[f"own_{mode}_{clip}"] for r in results):
        assert got["step"] == 1
        _close(got["grads"], want["grads"], OWN_RTOL)
        _close(got["state"], want["state"], OWN_RTOL)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=OWN_RTOL)
        np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=OWN_RTOL)
    # the ranks drew other sub-batches: no rank's own gradient is the mean
    assert want["local_grads_differ"]


def jax_clipped_mean_grads(mode, jmodel, jcfg, variables, batch):
    """The JAX loss's gradient on each rank's rows of the host batch, the two
    averaged, then clipped by optax's ``clip_by_global_norm`` → (gradient,
    the averaged gradient's global norm)."""
    loss_fn = (jsteps.siamese_loss_fn if mode == "siamese"
               else jsteps.classifier_loss_fn)(jmodel, jcfg)
    shards = []
    for r in range(WORLD):
        rows = [a[r * BATCH // WORLD:(r + 1) * BATCH // WORLD] for a in batch]
        xs = [jsteps.preprocess_fragments(f, jcfg) for f in rows[:-1]]
        _, g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], *xs, rows[-1], jax.random.PRNGKey(0))
        shards.append(g)
    mean = jax.tree_util.tree_map(lambda *gs: sum(gs) / WORLD, *shards)
    clip = optax.clip_by_global_norm(jcfg.train.clipnorm)
    clipped, _ = clip.update(mean, clip.init(mean))
    return (jax.tree_util.tree_map(np.asarray, clipped), float(optax.global_norm(mean)))


@pytest.mark.parametrize("mode,clip", MODES_CLIPS)
def test_the_streaming_dp_steps_match_jaxs(ranks, jax_side, mesh2, mode, clip):
    results, _ = ranks
    jmodel, _, variables = jax_side["models"][mode]
    jcfg = jax_config(experiment(mode, clip=clip))
    make = (jdp.make_dp_streaming_siamese_step if mode == "siamese"
            else jdp.make_dp_streaming_classifier_step)
    step, tx = make(jmodel, jcfg, mesh2)
    state = jstate.init_state(variables["params"], variables["batch_stats"], tx,
                              jcfg.train.learning_rate)
    batch = [jnp.asarray(a) for a in jax_side["stream"][mode]]
    new, m = step(state, *batch, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(np.asarray, {"params": new.params,
                                               "batch_stats": new.batch_stats})
    # the clip acts on the averaged gradient (Adam's first step is blind to
    # a gradient's scale, so the updated parameters alone would not show it)
    want_grads, norm = jax_clipped_mean_grads(mode, jmodel, jcfg, variables, batch)
    assert (norm > CLIPS[clip]) is (clip == "active")
    enc = experiment(mode).encoder
    lr = jcfg.train.learning_rate
    for got in (r[f"stream_{mode}_{clip}"] for r in results):
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=JAX_TOL)
        np.testing.assert_allclose(got["accuracy"], float(m["accuracy"]), rtol=JAX_TOL)
        # A siamese loss sees e1 − e2 only: the last block's BatchNorm bias,
        # the scales of the channels the pair's difference cancels and the
        # embedding bias get gradients that are zero but for rounding on both
        # sides, and Adam's first step turns such a gradient into a move of
        # up to lr either way. So an updated entry may miss JAX_TOL only
        # where its gradient is such a zero (|g| at most ZERO_GRAD of the
        # largest), and then by at most two steps.
        grads = to_flax(got["grads"], enc)["params"]
        top = max(float(g.abs().max()) for g in got["grads"].values())
        assert (jax.tree_util.tree_structure(grads)
                == jax.tree_util.tree_structure(want_grads))
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_grads),
                                jax.tree_util.tree_leaves(grads)):
            np.testing.assert_allclose(g, w, rtol=0, atol=JAX_TOL * top, err_msg=str(path))
        if mode == "siamese":
            assert np.abs(grads["encoder"]["embed"]["bias"]).max() <= ZERO_GRAD * top
            assert np.abs(grads["encoder"]["block_3"]["bn"]["bias"]).max() <= ZERO_GRAD * top
        params = to_flax(got["state"], enc)
        for (path, g), w, d in zip(jax.tree_util.tree_leaves_with_path(params["params"]),
                                   jax.tree_util.tree_leaves(want["params"]),
                                   jax.tree_util.tree_leaves(grads)):
            zero = np.abs(d) <= ZERO_GRAD * top
            miss = np.abs(g - w) > JAX_TOL * (1 + np.abs(w))
            assert not (miss & ~zero).any(), (path, np.abs(g - w)[miss & ~zero].max())
            np.testing.assert_allclose(g[zero], w[zero], rtol=0, atol=2 * lr, err_msg=str(path))
        assert_tree_close(params["batch_stats"], want["batch_stats"], JAX_TOL)
    key = f"stream_{mode}_{clip}"
    assert results[0][key]["state"].keys() == results[1][key]["state"].keys()
    for k, v in results[0][key]["state"].items():
        assert torch.equal(v, results[1][key]["state"][k]), k


def test_the_batch_must_divide_the_ranks_as_in_jax(ranks, jax_side, mesh2):
    results, _ = ranks
    jmodel, jcfg, _ = jax_side["models"]["classifier"]
    with pytest.raises(ValueError) as e:
        jdp.make_dp_classifier_train_step(jmodel, jax_config(experiment(batch=7)), mesh2)
    for got in results:
        assert got["error_batch"] == str(e.value)
        assert got["fit_error"] == "dp='on' but batch_size 7 does not divide the 2 devices"


def test_fit_dp_on_trains_replicated_and_rank_0_writes(ranks):
    results, tmp = ranks
    fits = [r["fit"] for r in results]
    assert [f["step"] for f in fits] == [FIT_STEPS] * WORLD
    for k, v in fits[0]["state"].items():
        assert torch.equal(v, fits[1]["state"][k]), k
    records = [json.loads(line) for line in (tmp / "fit.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [FIT_EVERY, FIT_STEPS]
    strip = lambda h: [{k: v for k, v in r.items() if k not in ("wall_s", "utterances_per_sec")}
                       for r in h]  # noqa: E731
    assert strip(records) == strip(fits[0]["history"]) == strip(fits[1]["history"])
    assert all(np.isfinite(r["loss"]) for r in records)
    assert sorted(os.listdir(tmp / "ckpt" / "latest")) == [f"{FIT_EVERY}.pt", f"{FIT_STEPS}.pt"]


def test_fit_dp_on_in_one_process_warns_and_trains():
    cfg = experiment(num_steps=2, evaluate_every=2, num_eval_tasks=10, k_way=3)
    with pytest.warns(UserWarning, match="single attached device"):
        state, history = fit(cfg, host_store(), device="cpu", verbose=False, dp="on")
    assert state.step == 2 and len(history) == 1


@pytest.mark.parametrize("dp,world,batch,device,want", [
    ("on", 2, 8, "cpu", True), ("on", 1, 8, "cuda", False), ("on", 1, 7, "cpu", False),
    ("auto", 2, 8, "cuda", True), ("auto", 2, 8, "cpu", False), ("auto", 2, 7, "cuda", False),
    ("auto", 1, 8, "cuda", False), ("off", 2, 8, "cuda", False)])
def test_use_data_parallel_follows_the_jax_rules(dp, world, batch, device, want):
    """``on`` with more than one rank, ``auto`` with more than one rank on
    the card (the JAX rule's TPU) and a batch that divides them, ``off``
    never (``voicemap_tpu/train/loop.py``'s ``use_dp``)."""
    assert use_data_parallel(dp, world, batch, device) is want


def test_use_data_parallel_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="does not divide the 2 devices"):
        use_data_parallel("on", 2, 7, "cpu")
    with pytest.raises(ValueError, match="dp must be"):
        use_data_parallel("sharded", 2, 8, "cpu")


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    for name in ("VOICEMAP_NUM_PROCESSES", "VOICEMAP_PROCESS_ID", "VOICEMAP_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False is jdistributed.initialize()
    assert distributed.initialize(num_processes=1, device="cpu") is False
    assert distributed.world_size() == 1 and distributed.rank() == 0
    monkeypatch.setenv("VOICEMAP_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="VOICEMAP_PROCESS_ID"):
        distributed.initialize(device="cpu")
    monkeypatch.setenv("VOICEMAP_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="VOICEMAP_COORDINATOR"):
        distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_global_mesh_checks_coverage_in_one_process():
    """The coverage errors come before any process group is needed; their
    words are the JAX package's, with the world's rank count."""
    with pytest.raises(ValueError, match=r"does not cover the 1 global devices"):
        distributed.global_mesh({"data": 3})
    with pytest.raises(ValueError, match=r"not in mesh axes"):
        distributed.global_mesh({"data": 1}, {"model": 2})
    with pytest.raises(ValueError) as jerr:
        jdistributed.global_mesh({"data": 3})
    with pytest.raises(ValueError) as err:
        distributed.global_mesh({"data": 3})
    assert str(err.value) == str(jerr.value).replace(f"{len(jax.devices())} global", "1 global")


def test_the_global_mesh_over_two_ranks(ranks):
    results, _ = ranks
    for got in results:
        assert got["initialized"] is True
        assert got["global"] == [0, 1] and got["global_2d"] == [[0], [1]]
        assert got["hybrid"] == [0, 1]  # slice-major: rank 0's slice first
        assert got["error_cover"] == "mesh {'data': 3} does not cover the 2 global devices"
        assert got["error_hybrid"] == ("ici mesh {'data': 2} × dcn mesh {'data': 2} does not "
                                       "cover the 2 global devices")
        assert got["error_dcn_axis"] == "dcn axes {'model'} not in mesh axes ('data',)"
