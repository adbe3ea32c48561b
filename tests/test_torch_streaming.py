"""The port's streaming path against the JAX package's, on the CPU: the
pipeline's batches, the embed batches, the fragment preprocessing, the
streaming train steps, ``embed_all_streaming`` with ``quantize_from_frags``,
and ``fit`` from a corpus on disk.

The host draws are numpy on both sides, so batches are held equal. The
stochastic offsets of the streaming path are cut on the host at any sample,
where the store path decimates once at a fixed phase (ROADMAP §C Traps), so
the streaming path is held against the JAX streaming path only. Tolerances,
each with its reason:

- f32 preprocessing: 1e-5 relative, 1e-6 absolute (whitening's sums in
  another order);
- f32 steps, tables, ``fit``'s losses: 1e-4 relative (the two frameworks'
  convs, reductions and Adam sum in other orders);
- bf16 tables: row cosine ≥ 0.999 (the two frameworks round a bf16 conv and
  its bias at other places);
- int8: the calibration scales 1e-5 relative at f32 and ``w_q`` within one
  step (a weight on a rounding boundary); tables, given the JAX qvars, row
  cosine ≥ 0.99999 (an int8 activation may land on the neighbouring step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from test_torch_train_forward import assert_tree_close
from voicemap_tpu.data import dataset as jdataset
from voicemap_tpu.data import pipeline as jpipeline
from voicemap_tpu.data import synthetic as jsynthetic
from voicemap_tpu.eval import nshot as jnshot
from voicemap_tpu.models import quant_infer as jq
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.models.siamese import SiameseNet as JaxSiamese
from voicemap_tpu.models.spectrogram import MelSpecClassifier as JaxMel
from voicemap_tpu.ops import preprocess as jpreprocess
from voicemap_tpu.train import loop as jloop
from voicemap_tpu.train import state as jstate
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, MelConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.data import dataset, pipeline
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models import quant_infer as tq
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, qvars_from_numpy, to_flax
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.models.spectrogram import MelSpecClassifier
from voicemap_tpu_torch.ops import preprocess
from voicemap_tpu_torch.train import loop, steps
from voicemap_tpu_torch.train.state import init_state

F32_RTOL = 1e-4
BF16_MIN_COSINE = 0.999
INT8_MIN_COSINE = 0.99999
MEL = MelConfig(hop_length=128, win_length=384, n_mels=32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A FLAC corpus in LibriSpeech's layout: dev-clean for training and
    test-clean for validation, each 6 speakers × 5 utterances of 0.6–1.2 s."""
    root = str(tmp_path_factory.mktemp("stream_corpus"))
    jsynthetic.generate_corpus(root, ("dev-clean", "test-clean"), jsynthetic.SyntheticSpec(
        n_speakers=6, utterances_per_speaker=5, min_seconds=0.6, max_seconds=1.2,
        container="flac", seed=5))
    return root


def experiment(root, mode="classifier", dtype="float32", **train):
    enc = EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, compute_dtype=dtype)
    train = {"batch_size": 6, **train}
    return ExperimentConfig(
        mode=mode, data=DataConfig(data_root=root, subsets=("dev-clean",), seconds=0.5,
                                   downsampling=1 if mode == "melspec2d" else 4,
                                   use_cache=False),
        encoder=enc, siamese=SiameseConfig(same_label=train.pop("same_label", 0)),
        mel=MEL, train=TrainConfig(**train))


def datasets(cfg, seed=0):
    return (dataset.dataset_from_config(cfg.data, seed=seed),
            jdataset.dataset_from_config(jax_config(cfg.data), seed=seed))


@pytest.mark.parametrize("mode,same", [("classifier", 0), ("siamese", 0), ("siamese", 1)])
def test_the_streaming_pipeline_gives_the_jax_pipelines_batches(root, mode, same):
    cfg = experiment(root, "siamese" if mode == "siamese" else "classifier", same_label=same)
    t, j = datasets(cfg)
    tp = pipeline.StreamingPipeline(t, cfg, mode=mode, seed=9)
    jp = jpipeline.StreamingPipeline(j, jax_config(cfg), mode=mode, seed=9)
    try:
        for _ in range(3):
            got, want = next(tp), next(jp)
            assert len(got) == len(want) == (2 if mode == "classifier" else 3)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        if mode == "siamese":
            assert got[2].tolist() == [same] * 3 + [1 - same] * 3
    finally:
        tp.close()
        jp.close()
    assert tp.closed


def test_iter_embed_batches_gives_the_jax_batches(root):
    cfg = experiment(root)
    t, j = datasets(cfg)
    got = list(pipeline.iter_embed_batches(t, cfg, 7))
    want = list(jpipeline.iter_embed_batches(j, jax_config(cfg), 7))
    assert [c for _, c in got] == [c for _, c in want] == [7, 7, 7, 7, 2]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[-1][0][2:].any()  # zero-padded past valid_count


def test_a_producer_error_reaches_the_consumer(root):
    cfg = experiment(root)
    t, _ = datasets(cfg)
    t.datasetid_to_filepath[0] = "missing.flac"
    t.datasetid_to_filepath[1] = "missing2.flac"
    with pytest.raises(RuntimeError, match="producer failed"):
        list(pipeline.iter_embed_batches(t, cfg, 4))
    p = pipeline.StreamingPipeline(t, dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=64)), seed=1)
    try:
        with pytest.raises(RuntimeError, match="producer failed"):
            for _ in range(20):
                next(p)
    finally:
        p.close()


def test_fragment_preprocessing_matches_jax():
    rng = np.random.default_rng(2)
    rows = rng.integers(-3000, 3000, (4, 900)).astype(np.int16)
    offsets = np.asarray([0, 7, 100, 500], np.int32)
    got = preprocess.extract_fragments(torch.from_numpy(rows), torch.from_numpy(offsets), 400)
    want = jpreprocess.extract_fragments(jnp.asarray(rows), jnp.asarray(offsets), 400)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for src in (rows, rows.astype(np.float32) / 5000):
        got = preprocess.preprocess_batch(torch.from_numpy(src), torch.from_numpy(offsets),
                                          400, 4)
        want = jpreprocess.preprocess_batch(jnp.asarray(src), jnp.asarray(offsets),
                                            fragment_length=400, downsampling=4)
        assert got.shape == want.shape == (4, 100, 1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    cfg = ExperimentConfig(data=DataConfig(seconds=0.025, downsampling=4))
    frags = rows[:, :400]
    got = steps.preprocess_fragments(torch.from_numpy(frags), cfg)
    want = jsteps.preprocess_fragments(jnp.asarray(frags), jax_config(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def classifier_pair(cfg, classes, seed):
    jcfg = jax_config(cfg)
    x = jnp.zeros((1, cfg.data.model_length, 1))
    if cfg.mode == "melspec2d":
        jmodel = JaxMel(jcfg.encoder, jcfg.mel, classes)
        model = MelSpecClassifier(cfg.encoder, cfg.mel, classes, device="cpu")
    else:
        jmodel = JaxClassifier(jcfg.encoder, num_classes=classes)
        model = SpeakerClassifier(cfg.encoder, classes, device="cpu")
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), x), seed)
    model.load_state_dict(from_flax(variables, cfg.encoder))
    return jcfg, jmodel, variables, model


def test_the_streaming_classifier_step_matches_jax(root):
    cfg = experiment(root, clipnorm=1e3)
    t, _ = datasets(cfg)
    p = pipeline.StreamingPipeline(t, cfg, seed=4)
    frags, y = next(p)
    p.close()
    jcfg, jmodel, variables, model = classifier_pair(cfg, t.num_classes(), 3)
    x = jsteps.preprocess_fragments(jnp.asarray(frags), jcfg)
    (jl, (new_bs, _)), grads = jax.value_and_grad(
        jsteps.classifier_loss_fn(jmodel, jcfg), has_aux=True)(
        variables["params"], variables["batch_stats"], x, jnp.asarray(y), jax.random.PRNGKey(0))
    step, _ = steps.make_streaming_classifier_step(model, cfg)
    state, m = step(init_state(model, 1e3, 1e-3), frags, y, None)
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=F32_RTOL)
    got = to_flax({n: q.grad for n, q in model.named_parameters()}, cfg.encoder)["params"]
    assert_tree_close(got, grads, F32_RTOL)
    assert_tree_close(to_flax(model.state_dict(), cfg.encoder)["batch_stats"], new_bs, F32_RTOL)


@pytest.mark.parametrize("metric", ["weighted_l1", "uniform_euclidean"])
@pytest.mark.parametrize("loss", ["bce", "contrastive"])
def test_the_streaming_siamese_step_matches_jax(root, loss, metric):
    cfg = experiment(root, "siamese", clipnorm=1e3, loss=loss)
    cfg = cfg.replace(siamese=SiameseConfig(distance_metric=metric))
    t, _ = datasets(cfg)
    p = pipeline.StreamingPipeline(t, cfg, mode="siamese", seed=4)
    f1, f2, y = next(p)
    p.close()
    jcfg = jax_config(cfg)
    jmodel = JaxSiamese(jcfg.encoder, jcfg.siamese)
    x1 = jsteps.preprocess_fragments(jnp.asarray(f1), jcfg)
    x2 = jsteps.preprocess_fragments(jnp.asarray(f2), jcfg)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(5), x1, x2), 5)
    model = SiameseNet(cfg.encoder, cfg.siamese, device="cpu")
    model.load_state_dict(from_flax(variables, cfg.encoder))
    (jl, _), grads = jax.value_and_grad(jsteps.siamese_loss_fn(jmodel, jcfg), has_aux=True)(
        variables["params"], variables["batch_stats"], x1, x2, jnp.asarray(y),
        jax.random.PRNGKey(0))
    step, _ = steps.make_streaming_siamese_step(model, cfg)
    _, m = step(init_state(model, 1e3, 1e-3), f1, f2, y, None)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=F32_RTOL)
    got = to_flax({n: q.grad for n, q in model.named_parameters() if q.grad is not None},
                  cfg.encoder)["params"]
    want = jax.tree_util.tree_map(np.asarray, grads)
    if loss == "contrastive":  # the head takes no part: its grad is None here, 0 there
        assert not np.any(want.pop("head")["kernel"])
    # 1e-4 absolute too: the last BatchNorm bias and the embedding bias cancel in
    # the BCE, so their gradients are rounding zeros on both sides
    assert_tree_close(got, want, F32_RTOL)


def cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def jax_state(variables):
    return jstate.init_state(variables["params"], variables["batch_stats"],
                             jstate.make_optimizer(), 1e-3)


@pytest.mark.parametrize("mode,dtype,fast", [("classifier", "bfloat16", True),
                                             ("classifier", "float32", False),
                                             ("melspec2d", "float32", False)])
def test_embed_all_streaming_matches_jax(root, mode, dtype, fast):
    """The streamed table against the JAX package's, row for row, and
    against the port's own device-store table of the same dataset (offset
    0: the two preprocessing routes agree there)."""
    cfg = experiment(root, mode, dtype)
    t, j = datasets(cfg)
    jcfg, jmodel, variables, model = classifier_pair(cfg, t.num_classes(), 7)
    got = nshot.embed_all_streaming(model, cfg, t, batch_size=8, fast=fast)
    want = np.asarray(jnshot.embed_all_streaming(jmodel, jax_state(variables), jcfg, j,
                                                 batch_size=8, fast=fast))
    assert got.shape == want.shape == (len(t), 16) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(want).max())
    else:
        assert cosine(got.numpy(), want).min() >= BF16_MIN_COSINE
    store = steps.device_store_for(cfg, t.to_store(), "cpu")
    table = nshot.embed_all(model, store, cfg, batch_size=8, fast=fast)
    assert cosine(got.numpy(), table.numpy()).min() >= 0.99999


@pytest.mark.parametrize("mode", ["classifier", "melspec2d"])
def test_quantize_from_frags_and_the_int8_streamed_table_match_jax(root, mode):
    cfg = experiment(root, mode)
    t, j = datasets(cfg)
    jcfg, jmodel, variables, model = classifier_pair(cfg, t.num_classes(), 8)
    frags = next(pipeline.iter_embed_batches(t, cfg, 12))[0]
    own = tq.quantize_from_frags(model, cfg, frags)
    jqvars = jq.quantize_from_frags(jax_state(variables), jcfg, frags)
    np.testing.assert_allclose(np.asarray(own["s0"]), np.asarray(jqvars["s0"]), rtol=1e-5)
    assert own.get("kind") == jqvars.get("kind")
    for a, b in zip(own["blocks"], jqvars["blocks"]):
        assert np.abs(a["w_q"].numpy().astype(int) - np.asarray(b["w_q"]).astype(int)).max() <= 1
        for k in ("alpha", "beta", "gamma"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-5, atol=1e-6)
    qvars = qvars_from_numpy(jax.tree_util.tree_map(np.asarray, jqvars), "cpu")
    got = nshot.embed_all_streaming(model, cfg, t, batch_size=8, qvars=qvars)
    want = np.asarray(jnshot.embed_all_streaming(jmodel, jax_state(variables), jcfg, j,
                                                 batch_size=8, qvars=jqvars))
    assert cosine(got.numpy(), want).min() >= INT8_MIN_COSINE
    with pytest.raises(ValueError, match="kind"):
        nshot.embed_all_streaming(model, cfg.replace(
            mode="classifier" if mode == "melspec2d" else "melspec2d"), t, qvars=qvars)


def fit_config(root, mode):
    cfg = experiment(root, mode, batch_size=6, num_steps=6, evaluate_every=2,
                     num_eval_tasks=20, k_way=3, plateau_patience=100, learning_rate=3e-3)
    return cfg.replace(data=dataclasses.replace(cfg.data, val_subsets=("test-clean",)),
                       siamese=SiameseConfig(distance_metric="weighted_l1"))


@pytest.mark.parametrize("mode", ["classifier", "siamese"])
def test_streaming_fit_records_the_jax_streaming_fits_losses(root, mode, monkeypatch):
    """``fit(cfg, pipeline="streaming")`` from JAX's initial weights: the
    same batches (numpy draws on both sides), so the same loss in every
    record; accuracy differs by task draw and is not compared. Config #2's
    siamese net scores by ``weighted_l1``. (Under ``uniform_euclidean`` the
    step's gradients agree to 1e-4 as well, but a few of block 2's kernel
    elements sit within that of zero, and Adam's first update moves each by
    ±lr whatever its size, so the records part by 0.1% after one step.)"""
    cfg = fit_config(root, mode)
    jvariables = {}
    jax_init_state = jloop.init_model_state

    def jax_init(model, c):
        st = jax_init_state(model, c)
        jvariables.update(params=st.params, batch_stats=st.batch_stats)
        return st

    monkeypatch.setattr(jloop, "init_model_state", jax_init)
    _, jhistory = jloop.fit(jax_config(cfg), verbose=False, pipeline="streaming", dp="off")

    def port_init(c, num_classes, device, seed):
        model = (SiameseNet(c.encoder, c.siamese, device=device) if c.mode == "siamese"
                 else SpeakerClassifier(c.encoder, num_classes, device=device))
        model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, jvariables),
                                        c.encoder))
        return model

    monkeypatch.setattr(loop, "init_model", port_init)
    _, history = loop.fit(cfg, device="cpu", verbose=False, pipeline="streaming")
    assert [r["step"] for r in history] == [r["step"] for r in jhistory] == [2, 4, 6]
    np.testing.assert_allclose([r["loss"] for r in history], [r["loss"] for r in jhistory],
                               rtol=F32_RTOL)


def test_auto_picks_by_the_threshold_and_a_streaming_run_closes_its_producer(
        root, monkeypatch, capsys):
    cfg = fit_config(root, "classifier")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_steps=2, evaluate_every=2))
    made = []

    class Recorded(pipeline.StreamingPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(pipeline, "StreamingPipeline", Recorded)
    loop.fit(cfg, device="cpu", streaming_threshold_bytes=0)
    assert "pipeline=auto → streaming" in capsys.readouterr().out
    assert len(made) == 1 and made[0].closed
    loop.fit(cfg, device="cpu", streaming_threshold_bytes=1 << 40)
    assert "pipeline=auto → device" in capsys.readouterr().out and len(made) == 1
    loop.fit(cfg, device="cpu", verbose=False)  # the host's memory share: a store
    assert len(made) == 1

    def boom(i, m):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        loop.fit(cfg, device="cpu", verbose=False, pipeline="streaming", on_step=boom)
    assert len(made) == 2 and made[1].closed
    with pytest.raises(ValueError, match="dp must be"):
        loop.fit(cfg, device="cpu", dp="sharded")
    with pytest.raises(ValueError, match="device pipeline"):
        loop.fit(cfg, dataset.dataset_from_config(cfg.data).to_store(), device="cpu",
                 pipeline="streaming")


def test_a_streaming_run_without_val_subsets_evaluates_a_bounded_sub_store(root, monkeypatch):
    cfg = fit_config(root, "classifier")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, val_subsets=None),
                      train=dataclasses.replace(cfg.train, num_steps=1))
    seen = []
    monkeypatch.setattr(nshot, "evaluate", lambda model, store, *a, **k: seen.append(store)
                        or 0.5)
    with pytest.warns(UserWarning, match="TRAINING store"):
        loop.fit(cfg, device="cpu", verbose=False, pipeline="streaming",
                 max_store_seconds=0.8)
    assert seen[0].audio.shape[1] <= int(0.8 * 16000) // 4 + 1
    strict = cfg.replace(train=dataclasses.replace(cfg.train, require_holdout_eval=True))
    with pytest.raises(ValueError, match="val_subsets"):
        loop.fit(strict, device="cpu", verbose=False, pipeline="streaming")


def test_make_embed_fn_matches_jax(root):
    """Store rows at offset 0 through the port's ``make_embed_fn`` (B1's
    plain version on the decimated store, the model's own forward) against
    the JAX package's (the raw store's gather, decimate, whiten)."""
    from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore

    cfg = experiment(root)
    t, _ = datasets(cfg)
    jcfg, jmodel, variables, model = classifier_pair(cfg, t.num_classes(), 9)
    host = t.to_store()
    idx = np.asarray([0, 5, 17, 3], np.int32)
    jstore = jsteps.device_store_for(jcfg, JaxAudioStore(**dataclasses.asdict(host)))
    want = np.asarray(jsteps.make_embed_fn(jmodel, jcfg)(
        jax_state(variables), jstore, jnp.asarray(idx), jax.random.PRNGKey(0)))
    got = steps.make_embed_fn(model, cfg)(steps.device_store_for(cfg, host, "cpu"),
                                          torch.from_numpy(idx))
    assert got.shape == want.shape == (4, 16) and not model.training
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())
