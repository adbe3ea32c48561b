"""``eval/nshot.evaluate_sweep``, the ad-hoc ``evaluate`` and
``evaluate_verification`` of the port against the JAX package's at the same
``PRNGKey``, on one seeded store and the same f32 weights: the replayed key
stream draws the JAX tasks and pairs, so each accuracy is held within one
task of the JAX value, EER and AUC within 1e-3, and the skipped points and
their reasons equal."""

import dataclasses

import jax
import numpy as np
import pytest

from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore
from voicemap_tpu.eval import nshot as jnshot
from voicemap_tpu.eval import verification as jverification
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.models.siamese import SiameseNet as JaxSiamese
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu.train.loop import init_model_state
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.eval import nshot, verification
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.ops import jax_random
from voicemap_tpu_torch.train.steps import device_store_for
from test_torch_config import jax_config

TASKS = 200
ONE_TASK = 1.0 / TASKS + 1e-6
METRIC_TOL = 1e-3
SPEAKERS, UTTS = 8, 4


@pytest.fixture(scope="module", params=["classifier", "siamese"])
def setup(request):
    """Port and JAX models with the same f32 weights and one store in both
    packages (8 speakers × 4 utterances: the sweep skips k > 8 and n > 3)."""
    cfg = ExperimentConfig(
        mode=request.param, data=DataConfig(seconds=0.5, downsampling=4, stochastic=False),
        encoder=EncoderConfig(filters=8, embedding_dim=8, dropout=0.0, compute_dtype="float32"),
        siamese=SiameseConfig(distance_metric="weighted_l1"), train=TrainConfig(seed=2))
    jcfg = jax_config(cfg)
    if cfg.mode == "siamese":
        jmodel, model = (JaxSiamese(jcfg.encoder, jcfg.siamese),
                         SiameseNet(cfg.encoder, cfg.siamese, device="cpu"))
    else:
        jmodel, model = (JaxClassifier(jcfg.encoder, num_classes=SPEAKERS),
                         SpeakerClassifier(cfg.encoder, SPEAKERS, device="cpu"))
    state = init_model_state(jmodel, jcfg)
    model.load_state_dict(from_flax({"params": state.params, "batch_stats": state.batch_stats},
                                    cfg.encoder))
    host = synthetic_store(11, SPEAKERS, UTTS, min_seconds=0.5, max_seconds=0.8)
    store = device_store_for(cfg, host, "cpu")
    jstore = jsteps.device_store_for(jcfg, JaxAudioStore(**dataclasses.asdict(host)))
    return model.eval(), store, cfg, jmodel, state, jstore, jcfg


def test_the_sweep_equals_the_jax_packages(setup):
    model, store, cfg, jmodel, state, jstore, jcfg = setup
    n_shots, k_values = (1, 3, 4), (2, 5, 8, 9)
    got = nshot.evaluate_sweep(model, store, cfg, jax_random.PRNGKey(7), n_shots, k_values,
                               num_tasks=TASKS)
    want = jnshot.evaluate_sweep(jmodel, state, jstore, jcfg, jax.random.PRNGKey(7), n_shots,
                                 k_values, num_tasks=TASKS)
    assert len(got) == len(want) == len(n_shots) * len(k_values)
    skipped = 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: g[k] for k in g if k not in ("accuracy", "stderr")} == {
            k: w[k] for k in w if k not in ("accuracy", "stderr")}
        if "skipped" in g:
            skipped += 1
            continue
        assert abs(g["accuracy"] - w["accuracy"]) <= ONE_TASK, (g, w)
        assert g["stderr"] == pytest.approx(
            np.sqrt(max(g["accuracy"] * (1 - g["accuracy"]), 1e-12) / TASKS))
    # k = 9 for every n; n = 4 (needs 5 utterances of 4) for every k
    assert skipped == 2 + 4
    assert got[-1]["skipped"] == "k_way=9 exceeds the 8 eval-store speakers"
    assert got[2 * 4]["skipped"] == ("n_shot=4 needs ≥5 utterances per speaker; "
                                     "store minimum is 4")


def test_the_sweep_needs_a_replayed_key(setup):
    import torch

    model, store, cfg, *_ = setup
    with pytest.raises(TypeError, match="jax_random key"):
        nshot.evaluate_sweep(model, store, cfg, torch.Generator(), (1,), (2,))


@pytest.mark.parametrize("seed,n,k", [(0, 1, 5), (3, 3, 8), (1906, 1, 2)])
def test_adhoc_evaluate_equals_the_jax_packages(setup, seed, n, k):
    model, store, cfg, jmodel, state, jstore, jcfg = setup
    got = nshot.evaluate(model, store, cfg, jax_random.PRNGKey(seed), num_tasks=TASKS, n=n, k=k)
    want = jnshot.evaluate(jmodel, state, jstore, jcfg, jax.random.PRNGKey(seed),
                           num_tasks=TASKS, n=n, k=k)
    assert abs(got - want) <= ONE_TASK, (got, want)


@pytest.mark.parametrize("seed", [1, 7920])
def test_verification_equals_the_jax_packages(setup, seed):
    model, store, cfg, jmodel, state, jstore, jcfg = setup
    got = verification.evaluate_verification(model, store, cfg, jax_random.PRNGKey(seed),
                                             num_pairs=400)
    want = jverification.evaluate_verification(jmodel, state, jstore, jcfg,
                                               jax.random.PRNGKey(seed), num_pairs=400)
    assert got["num_pairs"] == want["num_pairs"] == 400
    for m in ("eer", "auc"):
        assert abs(got[m] - want[m]) <= METRIC_TOL, (m, got, want)
