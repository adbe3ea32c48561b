"""The port's frozen-protocol runner (``voicemap_tpu_torch/eval/protocol.py``)
against the JAX package's, on one synthetic corpus and the same f32 weights
(a flax tree carried across by ``from_flax``).

Both draw their tasks and pairs from the manifest's seeds (the port through
``ops/jax_random``'s replay), so the records are compared task for task:
each accuracy within one task of 500 of the JAX value, and every task whose
prediction differs shown to be a near-tie of the JAX embeddings' class
distances; EER and AUC within 1e-3; every other field equal."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from voicemap_tpu.data.dataset import SpeakerDataset as JaxDataset
from voicemap_tpu.eval import protocol as jprotocol
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.models.siamese import SiameseNet as JaxSiamese
from voicemap_tpu.train.loop import init_model_state
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.data import dataset as dataset_mod
from voicemap_tpu_torch.data.dataset import SpeakerDataset
from voicemap_tpu_torch.data.synthetic import SyntheticSpec, generate_corpus
from voicemap_tpu_torch.eval import nshot, protocol
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.ops import jax_random
from test_torch_config import jax_config

ONE_TASK = 1.0 / 500 + 1e-9  # the records round to 4 decimals: 1/500 = 0.002 exactly
METRIC_TOL = 1e-3  # EER and AUC
NEAR_TIE = 1e-4  # relative gap of the two nearest class distances of a differing task
# Fields every record must carry equal to the JAX package's.
ACC_FIELDS = ("entry", "num_tasks", "n_shot", "k_way", "subsets", "task_seed",
              "corpus_fingerprint", "corpus_verified", "corpus_problems",
              "comparable_to_reference", "int8")
VER_FIELDS = ("entry", "num_pairs", "n_same", "n_diff", "pair_seed", "same_label", "subsets",
              "corpus_verified", "corpus_problems", "comparable", "int8")


@pytest.fixture(scope="module")
def proto_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_proto_corpus")
    spec = SyntheticSpec(n_speakers=12, utterances_per_speaker=7, min_seconds=3.2,
                         max_seconds=4.0, seed=5)
    generate_corpus(str(root), ("dev-clean", "test-clean"), spec)
    return str(root)


def _cfg(root, mode="classifier"):
    return ExperimentConfig(
        mode=mode, data=DataConfig(data_root=root, subsets=("dev-clean",)),
        encoder=EncoderConfig(filters=4, embedding_dim=8, dropout=0.0, compute_dtype="float32"),
        siamese=SiameseConfig(distance_metric="weighted_l1"), train=TrainConfig())


@pytest.fixture(scope="module", params=["classifier", "siamese"])
def models(request, proto_corpus):
    """``(port model, JAX model, JAX state, port cfg, JAX cfg)`` with the same
    f32 weights: the JAX init, carried across by ``from_flax``."""
    cfg = _cfg(proto_corpus, request.param)
    jcfg = jax_config(cfg)
    if cfg.mode == "siamese":
        jmodel = JaxSiamese(jcfg.encoder, jcfg.siamese)
        model = SiameseNet(cfg.encoder, cfg.siamese, device="cpu")
    else:
        jmodel = JaxClassifier(jcfg.encoder, num_classes=12)
        model = SpeakerClassifier(cfg.encoder, 12, device="cpu")
    state = init_model_state(jmodel, jcfg)
    model.load_state_dict(from_flax({"params": state.params,
                                     "batch_stats": state.batch_stats}, cfg.encoder))
    return model.eval(), jmodel, state, cfg, jcfg


def _near_ties(model, cfg, jmodel, state, jcfg, root, entry, manifest):
    """The tasks of ``entry`` the two packages predict differently, each with
    the relative gap of the JAX table's two best class scores."""
    from voicemap_tpu.eval import nshot as jnshot
    from voicemap_tpu.train import steps as jsteps
    from voicemap_tpu_torch.train.steps import device_store_for

    data = dataclasses.replace(cfg.data, subsets=tuple(entry["subsets"]), stochastic=False)
    ds = dataset_mod.dataset_from_config(data)
    host = ds.to_store()
    store = device_store_for(cfg.replace(data=data), host, "cpu")
    jcfg = jcfg.replace(data=jax_config(data))
    jstore = jsteps.device_store_for(jcfg, JaxDataset(
        subsets=data.subsets, seconds=3.0, data_root=root, stochastic=False).to_store())
    jtable = torch.from_numpy(np.array(jnshot.embed_all(jmodel, state, jstore, jcfg)))
    table = nshot.embed_all(model, store, cfg.replace(data=data))
    tasks = jax_random.nshot_tasks(jax_random.PRNGKey(manifest["task_seed"]),
                                   host.speaker_utts, host.speaker_counts, entry["num_tasks"],
                                   entry["n_shot"], entry["k_way"])
    q, s = torch.from_numpy(tasks.query_idx), torch.from_numpy(tasks.support_idx)
    if nshot.uses_head(cfg):
        w, b = nshot.head_params(model)
        pred = nshot.siamese_nshot_predictions(table, q, s, w, b, cfg.siamese.distance_metric)
        jpred = nshot.siamese_nshot_predictions(jtable, q, s, w, b, cfg.siamese.distance_metric)
        from voicemap_tpu_torch.ops import distance as dist_ops

        scores = dist_ops.class_distances(dist_ops.head_scores(
            jtable[q.long()], jtable[s.long()].reshape(len(q), -1, jtable.shape[1]), w, b,
            cfg.siamese.distance_metric), entry["n_shot"], entry["k_way"])
    else:
        pred = nshot.classifier_nshot_predictions(table, q, s)
        jpred = nshot.classifier_nshot_predictions(jtable, q, s)
        d = torch.cdist(jtable[q.long()][:, None].double(),
                        jtable[s.long()].reshape(len(q), -1, jtable.shape[1]).double())[:, 0]
        scores = d.reshape(len(q), entry["k_way"], entry["n_shot"]).mean(-1)
    top2 = scores.sort(dim=-1).values[:, :2]
    gap = ((top2[:, 1] - top2[:, 0]) / top2.abs().max(dim=-1).values.clamp(min=1e-12))
    differ = torch.nonzero(pred != jpred).flatten().tolist()
    return [(t, float(gap[t])) for t in differ]


def _hold_accuracy(got, want, ties):
    assert abs(got["accuracy"] - want["accuracy"]) <= ONE_TASK, (got, want, ties)
    assert len(ties) <= 1 and all(g <= NEAR_TIE for _, g in ties), (
        f"{got['entry']}: tasks that differ and their relative class-score gaps: {ties}")
    for f in ACC_FIELDS:
        assert got[f] == want[f], f


def _hold_verification(got, want):
    for m in ("eer", "auc"):
        assert abs(got[m] - want[m]) <= METRIC_TOL, (m, got, want)
    for f in VER_FIELDS:
        assert got[f] == want[f], f


def test_the_manifest_is_the_jax_packages():
    assert protocol.load_manifest() == jprotocol.load_manifest()
    assert protocol.MANIFEST_PATH == jprotocol.MANIFEST_PATH


def test_fingerprints_and_corpus_checks_equal_the_jax_packages(proto_corpus):
    """Byte for byte: each subset's fingerprint, a combined dataset's, and
    the problems ``check_corpus`` finds per subset (pinned and not)."""
    m = jprotocol.load_manifest()
    ident = {}
    for s in ("dev-clean", "test-clean"):
        ds = SpeakerDataset(subsets=(s,), seconds=3.0, data_root=proto_corpus)
        jds = JaxDataset(subsets=(s,), seconds=3.0, data_root=proto_corpus)
        fp = protocol.corpus_fingerprint(ds)
        assert fp == jprotocol.corpus_fingerprint(jds) == protocol.corpus_fingerprint(ds.index)
        ident[s] = {"n_speakers": 12, "n_utterances": len(ds), "fingerprint": fp}
    both = SpeakerDataset(subsets=("dev-clean", "test-clean"), seconds=3.0,
                          data_root=proto_corpus)
    jboth = JaxDataset(subsets=("dev-clean", "test-clean"), seconds=3.0, data_root=proto_corpus)
    assert protocol.corpus_fingerprint(both) == jprotocol.corpus_fingerprint(jboth)
    for manifest in (m, dict(m, corpus_identity=ident)):
        fps, jfps = {}, {}
        for s in ("dev-clean", "test-clean", "train-clean-100"):
            got = protocol.check_corpus(both, s, manifest, fingerprints=fps)
            assert got == jprotocol.check_corpus(jboth, s, manifest, fingerprints=jfps)
        assert fps == jfps
    assert set(fps) == {"dev-clean", "test-clean"}
    wrong = dict(m, corpus_identity={**ident, "dev-clean": dict(ident["dev-clean"],
                                                                n_speakers=13)})
    assert protocol.check_corpus(both, "dev-clean", wrong) == jprotocol.check_corpus(
        jboth, "dev-clean", wrong) != []
    # the path prefix stands in where the index carries no subset column
    no_column = SpeakerDataset(subsets=("dev-clean", "test-clean"), seconds=3.0,
                               data_root=proto_corpus)
    no_column.index.subset[:] = ""
    assert protocol.check_corpus(no_column, "dev-clean", dict(m, corpus_identity=ident)) == []


def test_a_wrong_corpus_is_refused(models, proto_corpus):
    model, *_, cfg, _ = models
    with pytest.raises(ValueError, match="EVAL_PROTOCOL"):
        protocol.run_protocol(model, proto_corpus, cfg)


def test_the_protocol_equals_the_jax_packages(models, proto_corpus):
    """``run_protocol`` and ``run_verification_protocol`` at the manifest's
    own entries and seeds (500 tasks, 2,000 pairs) against the JAX runs."""
    model, jmodel, state, cfg, jcfg = models
    m = protocol.load_manifest()
    kw = dict(allow_corpus_mismatch=True, max_store_seconds=5.0)
    got = protocol.run_protocol(model, proto_corpus, cfg, store_cache={}, **kw)
    want = jprotocol.run_protocol(jmodel, state, proto_corpus, jcfg, **kw)
    assert len(got) == len(want) == len(m["entries"])
    for g, w, entry in zip(got, want, m["entries"]):
        ties = _near_ties(model, cfg, jmodel, state, jcfg, proto_corpus, entry, m)
        _hold_accuracy(g, w, ties)
        assert set(g) - set(w) == {"key_stream"}
        assert g["key_stream"] == jax_random.KEY_STREAM
        json.dumps(g)
    vgot = protocol.run_verification_protocol(model, proto_corpus, cfg, **kw)
    vwant = jprotocol.run_verification_protocol(jmodel, state, proto_corpus, jcfg, **kw)
    assert [v["entry"] for v in vgot] == ["dev-clean_verification", "test-clean_verification"]
    for g, w in zip(vgot, vwant):
        _hold_verification(g, w)
        assert set(g) - set(w) == {"key_stream"}
        assert g["n_same"] == g["n_diff"] == 1000


def test_the_int8_gate_equals_the_jax_packages(models, proto_corpus):
    """``int8_accuracy_gate``: the same verdict, every check's base and int8
    metric within the bounds above, the same check layout."""
    model, jmodel, state, cfg, jcfg = models
    m = protocol.load_manifest()
    m["entries"] = m["entries"][:2]
    kw = dict(manifest=m, allow_corpus_mismatch=True, max_store_seconds=5.0)
    got = protocol.int8_accuracy_gate(model, proto_corpus, cfg, **kw)
    want = jprotocol.int8_accuracy_gate(jmodel, state, proto_corpus, jcfg, **kw)
    assert got["int8_accuracy_gate"] == want["int8_accuracy_gate"]
    assert (got["z"], got["comparable_to_reference"]) == (want["z"], False)
    assert [(c["entry"], c["metric"]) for c in got["checks"]] == [
        (c["entry"], c["metric"]) for c in want["checks"]]
    for g, w in zip(got["checks"], want["checks"]):
        tol = ONE_TASK if g["metric"] == "accuracy" else METRIC_TOL
        assert abs(g["base"] - w["base"]) <= tol and abs(g["int8"] - w["int8"]) <= tol, (g, w)
    json.dumps(got)


def test_the_gate_fails_on_a_disagreement(models, proto_corpus, monkeypatch):
    """The z-test flips the verdict on a gap beyond z·sqrt(se² + se²)."""
    model, *_, cfg, _ = models

    def fake_run(model, data_root, cfg_base, int8=False, **kw):
        return [{"entry": "e", "accuracy": 0.90 if int8 else 0.70, "stderr": 0.02,
                 "comparable_to_reference": True}]

    monkeypatch.setattr(protocol, "run_protocol", fake_run)
    monkeypatch.setattr(protocol, "run_verification_protocol", lambda *a, **kw: [])
    verdict = protocol.int8_accuracy_gate(model, proto_corpus, cfg)
    assert verdict["int8_accuracy_gate"] == "fail" and not verdict["checks"][0]["agree"]
    assert verdict["comparable_to_reference"] is True


def test_the_store_cache_is_shared(models, proto_corpus, monkeypatch):
    """One cache across the accuracy and verification passes: the corpus is
    indexed, decoded and shipped once a subset, and embedded once."""
    model, *_, cfg, _ = models
    m = protocol.load_manifest()
    m["entries"] = [dict(m["entries"][0], num_tasks=20)]
    m["verification"]["entries"] = [dict(m["verification"]["entries"][0], num_pairs=50)]
    calls, embeds = [], []
    real, real_embed = dataset_mod.dataset_from_config, nshot.embed_all
    monkeypatch.setattr(dataset_mod, "dataset_from_config",
                        lambda c: (calls.append(1), real(c))[1])
    monkeypatch.setattr(nshot, "embed_all", lambda *a, **k: (embeds.append(1), real_embed(*a, **k))[1])
    cache = {}
    kw = dict(manifest=m, allow_corpus_mismatch=True, max_store_seconds=5.0, store_cache=cache)
    r_acc = protocol.run_protocol(model, proto_corpus, cfg, **kw)
    assert len(calls) == len(embeds) == 1
    r_ver = protocol.run_verification_protocol(model, proto_corpus, cfg, **kw)
    assert len(calls) == len(embeds) == 1
    assert len(r_acc) == len(r_ver) == 1
    assert ("dev-clean",) in cache
    assert ("table", id(model), False, False, "dev-clean") in cache


def test_a_v1_manifest_pins_no_verification(models, proto_corpus):
    model, *_, cfg, _ = models
    m = protocol.load_manifest()
    del m["verification"]
    assert protocol.run_verification_protocol(model, proto_corpus, cfg, manifest=m,
                                              allow_corpus_mismatch=True) == []
