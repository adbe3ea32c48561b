"""The port's pair sampler, EER/AUC and siamese scoring against the JAX
package's, on the CPU.

Torch generators cannot replay threefry: the port's pair sampler is held to
its invariants, and scoring is compared on the pairs and tasks that the JAX
samplers drew, from one seeded embedding table and one head. The four
metric functions are compared on seeded scores, ties included.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.eval import nshot as jnshot
from voicemap_tpu.eval import verification as jver
from voicemap_tpu.ops import sampling as jsampling
from test_torch_config import jax_config
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.eval import nshot, verification
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.ops import sampling
from voicemap_tpu_torch.train.steps import device_store_for

S, U, D = 9, 5, 16
SCORE_TOL = 1e-5  # f32 head logits, another summation order


def store_index(counts):
    """``(speaker_utts, counts, owner)``: ragged speakers, -1 in empty slots."""
    counts = np.asarray(counts, np.int32)
    utts = np.full((len(counts), counts.max()), -1, np.int32)
    nxt = 0
    for sp, c in enumerate(counts):
        utts[sp, :c] = np.arange(nxt, nxt + c)
        nxt += c
    return utts, counts, np.repeat(np.arange(len(counts)), counts)


@pytest.mark.parametrize("same_label", [0, 1])
def test_verification_batch_invariants(same_label):
    utts, counts, owner = store_index([2, 5, 3, 4, 2, 6, 3])
    g = torch.Generator().manual_seed(same_label)
    b = sampling.sample_verification_batch(g, torch.from_numpy(utts), torch.from_numpy(counts),
                                           401, same_label)
    i1, i2, y = b.idx_1.numpy(), b.idx_2.numpy(), b.labels.numpy()
    assert i1.shape == i2.shape == y.shape == (401,) and y.dtype == np.float32
    half = 200
    np.testing.assert_array_equal(y[:half], same_label)
    np.testing.assert_array_equal(y[half:], 1 - same_label)
    assert (i1 >= 0).all() and (i2 >= 0).all()  # never an empty slot
    assert (owner[i1[:half]] == owner[i2[:half]]).all()  # alike: one speaker
    assert (i1[:half] != i2[:half]).all()  # ... two distinct utterances
    assert (owner[i1[half:]] != owner[i2[half:]]).all()  # differing: two speakers
    assert len(set(owner[i1[:half]])) == len(counts)  # every speaker drawn
    again = sampling.sample_verification_batch(torch.Generator().manual_seed(same_label),
                                               torch.from_numpy(utts),
                                               torch.from_numpy(counts), 401, same_label)
    assert torch.equal(again.idx_1, b.idx_1) and torch.equal(again.idx_2, b.idx_2)


def test_pair_helpers_keep_their_invariants():
    utts, counts, owner = store_index([3, 2, 4, 5])
    g = torch.Generator().manual_seed(9)
    s1, s2 = sampling.sample_distinct_speakers(g, 4, (500,))
    assert (s1 != s2).all() and int(s1.max()) == 3 and int(s2.min()) == 0
    speakers = torch.randint(0, 4, (500,), generator=g)
    a, b = sampling._pick_two_distinct(g, torch.from_numpy(utts), torch.from_numpy(counts),
                                       speakers)
    assert (a != b).all() and (owner[a.numpy()] == speakers.numpy()).all()
    assert (owner[b.numpy()] == speakers.numpy()).all()
    one = sampling._pick_utterance(g, torch.from_numpy(utts), torch.from_numpy(counts),
                                   speakers)
    assert (one >= 0).all() and (owner[one.numpy()] == speakers.numpy()).all()
    with pytest.raises(ValueError):
        sampling.sample_distinct_speakers(g, 1, (3,))


def seeded_scores(seed, ties):
    rng = np.random.default_rng(seed)
    labels = (np.arange(300) >= 140).astype(np.float32)
    scores = rng.standard_normal(300) + 0.8 * labels
    if ties:
        scores = np.round(scores * 2) / 2  # many equal scores across classes
    return scores.astype(np.float32), labels


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("same_label", [0, 1])
def test_eer_auc_and_stderrs_equal_the_jax_functions(ties, same_label):
    scores, labels = seeded_scores(3 + same_label, ties)
    if same_label:
        labels = 1.0 - labels
    assert verification.eer_from_scores(scores, labels, same_label) == \
        jver.eer_from_scores(scores, labels, same_label)
    auc = verification.auc_from_scores(scores, labels, same_label)
    assert auc == jver.auc_from_scores(scores, labels, same_label)
    assert 0.5 < auc < 1.0
    n_same = int((labels == same_label).sum())
    for a in (auc, 0.0, 1.0):
        assert verification.auc_stderr(a, n_same, 300 - n_same) == \
            jver.auc_stderr(a, n_same, 300 - n_same)
    eer = verification.eer_from_scores(scores, labels, same_label)[0]
    assert verification.eer_stderr(eer, n_same, 300 - n_same) == \
        jver.eer_stderr(eer, n_same, 300 - n_same)
    with pytest.raises(ValueError):
        verification.eer_from_scores(scores, np.full(300, same_label), same_label)


def scoring_setup(metric, loss="bce", same_label=0):
    """A seeded table, a port net with a seeded head, the matching JAX
    config, a stand-in JAX state holding the same head, and the store index."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal((S * U, D)).astype(np.float32)
    cfg = ExperimentConfig(mode="siamese",
                           encoder=EncoderConfig(filters=8, embedding_dim=D),
                           siamese=SiameseConfig(distance_metric=metric, same_label=same_label),
                           train=TrainConfig(loss=loss))
    model = SiameseNet(cfg.encoder, cfg.siamese, device="cpu")
    width = model.head.weight.shape[1]
    kernel = rng.standard_normal((width, 1)).astype(np.float32)
    bias = np.array([0.4], np.float32)
    with torch.no_grad():
        model.head.weight.copy_(torch.from_numpy(kernel.T))
        model.head.bias.copy_(torch.from_numpy(bias))
    jstate = types.SimpleNamespace(params={"head": {"kernel": jnp.asarray(kernel),
                                                    "bias": jnp.asarray(bias)}})
    utts = np.arange(S * U, dtype=np.int32).reshape(S, U)
    counts = np.full(S, U, np.int32)
    return table, cfg, model, jax_config(cfg), jstate, utts, counts


@pytest.mark.parametrize("metric,loss,same_label", [("weighted_l1", "bce", 0),
                                                    ("weighted_l1", "bce", 1),
                                                    ("uniform_euclidean", "bce", 0),
                                                    ("weighted_l1", "contrastive", 0)])
def test_pair_scores_on_jax_pairs_match_jax(metric, loss, same_label):
    """BCE: the head's logits, negated under same_label = 1; contrastive:
    the embeddings' f64 euclidean distance, the head ignored."""
    table, cfg, model, jcfg, jstate, utts, counts = scoring_setup(metric, loss, same_label)
    key = jax.random.PRNGKey(5)
    jstore = types.SimpleNamespace(speaker_utts=jnp.asarray(utts),
                                   speaker_counts=jnp.asarray(counts))
    want, want_labels = jver.verification_scores(None, jstate, jstore, jcfg, key,
                                                 num_pairs=64, table=jnp.asarray(table))
    batch = jsampling.sample_verification_batch(key, jnp.asarray(utts), jnp.asarray(counts),
                                                64, same_label)
    np.testing.assert_array_equal(np.asarray(batch.labels), want_labels)
    got = verification.pair_scores(torch.from_numpy(table),
                                   torch.from_numpy(np.array(batch.idx_1)),
                                   torch.from_numpy(np.array(batch.idx_2)), cfg, model)
    if loss == "contrastive":
        assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_TOL, atol=SCORE_TOL)
    assert verification.eer_from_scores(got.numpy(), want_labels, same_label)[0] == \
        pytest.approx(jver.eer_from_scores(want, want_labels, same_label)[0], abs=1e-9)


@pytest.mark.parametrize("metric,same_label", [("weighted_l1", 0), ("weighted_l1", 1),
                                               ("cosine_distance", 0)])
def test_siamese_nshot_predictions_on_jax_tasks_give_jax_accuracy(metric, same_label):
    table, cfg, model, _, _, utts, counts = scoring_setup(metric, "bce", same_label)
    key = jax.random.PRNGKey(7)
    n, k, tasks = 2, 4, 300
    jt = jsampling.sample_nshot_tasks(key, jnp.asarray(utts), jnp.asarray(counts), tasks, n, k)
    w, b = nshot.head_params(model)
    pred = nshot.siamese_nshot_predictions(
        torch.from_numpy(table), torch.from_numpy(np.array(jt.query_idx)),
        torch.from_numpy(np.array(jt.support_idx)), w, b, metric, same_label).numpy()
    kernel = model.head.weight.detach().numpy().T
    want = float(jnshot.siamese_nshot_accuracy(
        jnp.asarray(table), jnp.asarray(kernel), float(b), jnp.asarray(utts),
        jnp.asarray(counts), key, tasks, n, k, metric=metric, same_label=same_label))
    assert np.mean(pred == 0) == pytest.approx(want, abs=1e-6)
    assert 0.0 < want < 1.0  # random embeddings: the comparison is not vacuous


def test_score_table_follows_the_use_head_rule():
    """A BCE net scores by its head; a contrastive one, by embedding
    distance, exactly as the classifier does; the head rule needs the net."""
    host = synthetic_store(3, n_speakers=5, utterances_per_speaker=3, min_seconds=0.2,
                           max_seconds=0.3)
    table, cfg, model, *_ = scoring_setup("weighted_l1")
    cfg = cfg.replace(data=DataConfig(seconds=0.1, downsampling=4))
    store = device_store_for(cfg, host, "cpu")
    table = torch.from_numpy(table[:15])
    contrastive = cfg.replace(train=TrainConfig(loss="contrastive"))
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    by_distance = nshot.score_table(table, store, contrastive, g(), 200, 1, 3, model=model)
    classifier = nshot.classifier_nshot_accuracy(table, store.speaker_utts,
                                                 store.speaker_counts, g(), 200, 1, 3)
    assert by_distance == float(classifier)
    by_head = nshot.score_table(table, store, cfg, g(), 200, 1, 3, model=model)
    want = nshot.siamese_nshot_accuracy(table, *nshot.head_params(model), store.speaker_utts,
                                        store.speaker_counts, g(), 200, 1, 3, "weighted_l1")
    assert by_head == float(want)
    with pytest.raises(ValueError):
        nshot.score_table(table, store, cfg, g(), 10, 1, 3)  # no net for the head


def test_evaluate_verification_reports_finite_rates():
    host = synthetic_store(4, n_speakers=5, utterances_per_speaker=3, min_seconds=0.2,
                           max_seconds=0.3)
    cfg = ExperimentConfig(mode="siamese", data=DataConfig(seconds=0.1, downsampling=4),
                           encoder=EncoderConfig(filters=8, embedding_dim=8),
                           siamese=SiameseConfig(distance_metric="weighted_l1"))
    model = SiameseNet(cfg.encoder, cfg.siamese, device="cpu")
    store = device_store_for(cfg, host, "cpu")
    rep = verification.evaluate_verification(model, store, cfg, torch.Generator().manual_seed(0),
                                             num_pairs=40, embed_batch=4)
    assert rep["num_pairs"] == 40
    assert 0.0 <= rep["eer"] <= 1.0 and 0.0 <= rep["auc"] <= 1.0
    assert np.isfinite(rep["eer_threshold"])
