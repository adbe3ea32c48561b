"""The port's n-shot evaluation against the JAX package's, on the CPU.

Torch generators cannot replay threefry, so scoring is compared on the task
indices the JAX sampler drew, the port's sampler is tested for its
invariants, and ``embed_all`` is compared on deterministic (offset-0)
fragments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.eval import nshot as jnshot
from voicemap_tpu.ops import distance as jdist
from voicemap_tpu.ops import sampling as jsampling
from voicemap_tpu_torch.config import DataConfig, EncoderConfig, ExperimentConfig
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax
from voicemap_tpu_torch.ops import distance as tdist
from voicemap_tpu_torch.ops.sampling import sample_nshot_tasks
from voicemap_tpu_torch.train.steps import device_store_for
from test_torch_config import jax_config

DIST_TOL = 1e-5  # f32, other reduction order


def _qs(seed, nq=5, ns=7, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nq, d)).astype(np.float32),
            rng.standard_normal((ns, d)).astype(np.float32))


@pytest.mark.parametrize("name", ["pairwise_sq_euclidean", "pairwise_euclidean",
                                  "pairwise_l1", "pairwise_cosine_distance",
                                  "pairwise_dot"])
def test_pairwise_distances_match_jax(name):
    q, s = _qs(0)
    got = getattr(tdist, name)(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    want = np.asarray(getattr(jdist, name)(jnp.asarray(q), jnp.asarray(s)))
    np.testing.assert_allclose(got, want, rtol=DIST_TOL, atol=DIST_TOL)


def test_weighted_l1_matches_jax():
    q, s = _qs(1)
    w = np.random.default_rng(2).standard_normal((16, 1)).astype(np.float32)
    got = tdist.pairwise_weighted_l1(torch.from_numpy(q), torch.from_numpy(s),
                                     torch.from_numpy(w), torch.tensor(0.3)).numpy()
    want = np.asarray(jdist.pairwise_weighted_l1(jnp.asarray(q), jnp.asarray(s),
                                                 jnp.asarray(w), 0.3))
    np.testing.assert_allclose(got, want, rtol=DIST_TOL, atol=DIST_TOL)


@pytest.mark.parametrize("metric", jdist.SIAMESE_METRICS)
def test_head_scores_and_class_distances_match_jax(metric):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    s = rng.standard_normal((5, 6, 16)).astype(np.float32)
    w = rng.standard_normal((16, 1)).astype(np.float32)
    got = tdist.head_scores(torch.from_numpy(q), torch.from_numpy(s),
                            torch.from_numpy(w), torch.tensor(-0.2), metric)
    want = jdist.head_scores(jnp.asarray(q), jnp.asarray(s), jnp.asarray(w), -0.2, metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DIST_TOL, atol=DIST_TOL)
    np.testing.assert_allclose(tdist.class_distances(got, 2, 3).numpy(),
                               np.asarray(jdist.class_distances(want, 2, 3)),
                               rtol=DIST_TOL, atol=DIST_TOL)
    assert tdist.SIAMESE_METRICS == jdist.SIAMESE_METRICS


@pytest.mark.parametrize("n,k", [(1, 5), (3, 4)])
def test_scoring_on_jax_tasks_gives_jax_accuracy(n, k):
    """Scores of the tasks JAX drew: the port's predictions equal a numpy
    nearest-class-mean rule, and their accuracy equals the JAX accuracy."""
    S, U, tasks = 10, 6, 300
    rng = np.random.default_rng(4)
    table = rng.standard_normal((S * U, 8)).astype(np.float32)
    utts = np.arange(S * U, dtype=np.int32).reshape(S, U)
    counts = np.full(S, U, np.int32)
    key = jax.random.PRNGKey(7)
    jt = jsampling.sample_nshot_tasks(key, jnp.asarray(utts), jnp.asarray(counts), tasks, n, k)
    q_idx, s_idx = np.array(jt.query_idx), np.array(jt.support_idx)
    pred = nshot.classifier_nshot_predictions(
        torch.from_numpy(table), torch.from_numpy(q_idx), torch.from_numpy(s_idx)).numpy()
    dist = np.linalg.norm(table[s_idx] - table[q_idx][:, None, None], axis=-1).mean(-1)
    np.testing.assert_array_equal(pred, dist.argmin(-1))
    want = float(jnshot.classifier_nshot_accuracy(
        jnp.asarray(table), jnp.asarray(utts), jnp.asarray(counts), key, tasks, n, k))
    assert np.mean(pred == 0) == pytest.approx(want, abs=1e-6)
    assert 0.0 < want < 1.0  # random embeddings: the comparison is not vacuous


@pytest.mark.parametrize("n,k", [(1, 5), (2, 3)])
def test_sampler_invariants(n, k):
    S, max_utt = 7, 5
    rng = np.random.default_rng(5)
    counts = rng.integers(n + 1, max_utt + 1, S).astype(np.int32)
    utts = np.full((S, max_utt), -1, np.int32)
    nxt = 0
    for sp in range(S):
        utts[sp, :counts[sp]] = np.arange(nxt, nxt + counts[sp])
        nxt += counts[sp]
    owner = np.repeat(np.arange(S), counts)
    g = torch.Generator().manual_seed(0)
    t = sample_nshot_tasks(g, torch.from_numpy(utts), torch.from_numpy(counts), 200, n, k)
    q, s = t.query_idx.numpy(), t.support_idx.numpy()
    assert q.shape == (200,) and s.shape == (200, k, n)
    assert (s >= 0).all() and (q >= 0).all()  # never a padded slot
    speakers = owner[s]  # (tasks, k, n)
    assert (speakers == speakers[..., :1]).all()  # a class is one speaker
    assert all(len(set(row)) == k for row in speakers[:, :, 0])  # k distinct
    assert (owner[q] == speakers[:, 0, 0]).all()  # the true class is 0
    class0 = np.concatenate([q[:, None], s[:, 0]], axis=1)
    assert all(len(set(row)) == n + 1 for row in class0)  # n+1 distinct utts
    again = sample_nshot_tasks(torch.Generator().manual_seed(0), torch.from_numpy(utts),
                               torch.from_numpy(counts), 200, n, k)
    np.testing.assert_array_equal(again.support_idx.numpy(), s)
    with pytest.raises(ValueError):
        sample_nshot_tasks(g, torch.from_numpy(utts), torch.from_numpy(counts), 5, n, S + 1)


@pytest.fixture(scope="module")
def small_eval():
    """A 4-speaker store, a converted f32 classifier, both packages' state and
    the JAX package's config with the port config's values."""
    from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore
    from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
    from voicemap_tpu.train import steps as jsteps
    from voicemap_tpu.train.state import init_state, make_optimizer

    cfg = ExperimentConfig(
        data=DataConfig(seconds=0.25, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16, compute_dtype="float32"))
    host = synthetic_store(8, n_speakers=4, utterances_per_speaker=3,
                           min_seconds=0.3, max_seconds=0.5)
    jcfg = jax_config(cfg)
    jmodel = JaxClassifier(jcfg.encoder, num_classes=4)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, cfg.data.model_length, 1)))
    jstate = init_state(variables["params"], variables["batch_stats"], make_optimizer(), 1e-3)
    jstore = jsteps.device_store_for(jcfg, JaxAudioStore(**dataclasses.asdict(host)))
    model = SpeakerClassifier(cfg.encoder, num_classes=4, device="cpu")
    model.load_state_dict(from_flax(variables, cfg.encoder))
    return cfg, host, model, jmodel, jstate, jstore, jcfg


def test_embed_all_matches_jax_fast(small_eval):
    """Chunked offset-0 tables of both packages agree at f32 (1e-4), for the
    fast and the module path, over a last chunk shorter than the rest."""
    cfg, host, model, jmodel, jstate, jstore, jcfg = small_eval
    want = np.asarray(jnshot.embed_all(jmodel, jstate, jstore, jcfg, batch_size=5, fast=True))
    store = device_store_for(cfg, host, "cpu")
    for fast in (True, False):
        got = nshot.embed_all(model, store, cfg, batch_size=5, fast=fast).numpy()
        assert got.shape == (12, 16)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_evaluate_guards_and_range(small_eval):
    cfg, host, model, *_ = small_eval
    store = device_store_for(cfg, host, "cpu")
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        nshot.evaluate(model, store, cfg, g, num_tasks=10, n=1, k=5)  # 4 speakers
    with pytest.raises(ValueError):
        nshot.evaluate(model, store, cfg, g, num_tasks=10, n=3, k=2)  # 3 utts each
    acc = nshot.evaluate(model, store, cfg, g, num_tasks=50, n=1, k=3, fast=True,
                         embed_batch=5)
    assert 0.0 <= acc <= 1.0
    # A siamese net's head scores its tasks: without the net there is no head.
    with pytest.raises(ValueError):
        nshot.score_table(torch.zeros(12, 16), store, cfg.replace(mode="siamese"), g, 5, 1, 2)
    with pytest.raises(ValueError):
        nshot.score_table(torch.zeros(12, 16), store, cfg.replace(mode="pairs"), g, 5, 1, 2)
