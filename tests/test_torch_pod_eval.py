"""Config #5 on the port (``voicemap_tpu_torch/parallel``): the sharded
distance matrix, the sharded embed table, the sharded task scorers and
``pod_evaluate``, at world size 3 on gloo, on the CPU.

World 3 pads the store's 35 rows to 36 and rounds 500 tasks to 498, which
world 2 would hide. One process group serves the module: ``ranks`` spawns
three processes once, each runs every case below and saves what it got,
and the tests read the files. The JAX side runs here, on a 3-device mesh of
the faked CPU devices. Tolerances, each with its reason:

- distances: f32 1e-5 (the two frameworks sum the matmul form in other
  orders); the nearest-support argmins equal (random data: no ties);
- the pod table against the port's single-process ``embed_all``: equal,
  bf16 and int8 included (the evaluation forward is per row, so shards and
  chunks do not change a row);
- the pod table against the JAX ``make_sharded_embed_table_fn`` on the
  same weights: 1e-4 at f32 (``test_torch_nshot``'s
  ``test_embed_all_matches_jax_fast``), row cosine 0.999 at bf16 (the
  frameworks round a bf16 conv at other places) and 0.99999 in int8 given
  the JAX qvars (an activation may land on the neighbouring step);
- the scorers against JAX's on one table and one key: equal accuracy but
  for tasks whose two best class scores lie within a relative 1e-4
  (``test_torch_protocol``'s near-tie rule);
- ``pod_evaluate`` against the single-device ``evaluate`` on the same key:
  equal, as floats.
"""

import dataclasses
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore
from voicemap_tpu.models import quant_infer as jq
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu.models.siamese import SiameseNet as JaxSiamese
from voicemap_tpu.parallel import mesh as jmesh
from voicemap_tpu.parallel import pod_eval as jpod
from voicemap_tpu.parallel import sharded_distance as jsd
from voicemap_tpu.train import state as jstate
from voicemap_tpu.train import steps as jsteps
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, qvars_from_numpy
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.ops import distance as tdist
from voicemap_tpu_torch.ops import jax_random
from voicemap_tpu_torch.parallel import distributed, pod_eval, sharded_distance
from voicemap_tpu_torch.parallel.mesh import data_mesh
from voicemap_tpu_torch.train.steps import device_store_for

WORLD = 3
SPEAKERS, UTTS = 7, 5  # 35 rows: one pad row at world 3
NUM_TASKS = 500  # 498 at world 3
EMBED_BATCH = 4
DIST_TOL = 1e-5
F32_TOL = 1e-4
BF16_MIN_COSINE = 0.999
INT8_MIN_COSINE = 0.99999
NEAR_TIE = 1e-4
KEY_SEED = 11
# (case, mode, compute dtype, int8, siamese metric, n, k)
CASES = (("float32", "classifier", "float32", False, None, 1, 3),
         ("bfloat16", "classifier", "bfloat16", False, None, 1, 3),
         ("int8", "classifier", "float32", True, None, 1, 3),
         ("weighted_l1", "siamese", "float32", False, "weighted_l1", 2, 3),
         ("uniform_euclidean", "siamese", "float32", False, "uniform_euclidean", 2, 3))
QS = (12, 15, 16)  # nq, ns, d of the distances: 4 query and 5 support rows a rank


def case_cfg(mode, dtype, metric):
    return ExperimentConfig(
        mode=mode, data=DataConfig(seconds=0.25, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16, compute_dtype=dtype),
        siamese=SiameseConfig(distance_metric=metric or "weighted_l1"))


def host_store():
    return synthetic_store(9, n_speakers=SPEAKERS, utterances_per_speaker=UTTS,
                           min_seconds=0.3, max_seconds=0.5)


def port_model(cfg, state_dict):
    model = (SiameseNet(cfg.encoder, cfg.siamese, device="cpu") if cfg.mode == "siamese"
             else SpeakerClassifier(cfg.encoder, SPEAKERS, device="cpu"))
    model.load_state_dict(state_dict)
    return model.eval()


def spawn(fn, world: int, tmp: Path, timeout: float = 240.0, meanwhile=None) -> None:
    """Run ``fn(rank, world, rendezvous, tmp)`` in ``world`` spawned
    processes, to join one gloo group through ``distributed.initialize`` at
    ``rendezvous`` (a file in ``tmp``: no port to race for); fail (and stop
    them) on an error or past ``timeout``. ``meanwhile()``, where given, runs
    here while they run."""
    rendezvous = f"file://{tmp / 'rendezvous'}"
    ctx = mp.start_processes(fn, args=(world, rendezvous, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        if meanwhile is not None:
            meanwhile()
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return str(e)
    return None


def _pod_rank(rank: int, world: int, rendezvous: str, tmp: str) -> None:
    """One rank: every case of the module, its results saved to rank<r>.pt."""
    torch.set_num_threads(1)
    assert distributed.initialize(rendezvous, world, rank, device="cpu")
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        mesh = data_mesh()
        out = {}
        q, s = inputs["q"], inputs["s"]
        nq, ns = q.shape[0] // world, s.shape[0] // world
        q_mine, s_mine = q[rank * nq:(rank + 1) * nq], s[rank * ns:(rank + 1) * ns]
        out["sharded"] = sharded_distance.sharded_sq_euclidean(q, s_mine, mesh)
        out["sharded_block"] = sharded_distance.sharded_sq_euclidean(q, s_mine, mesh,
                                                                     gather=False)
        out["nearest"] = sharded_distance.sharded_nearest_support(q, s_mine, mesh)
        out["ring_block"] = sharded_distance.ring_sq_euclidean(q_mine, s_mine, mesh)
        out["ring"] = sharded_distance.gather_columns(out["ring_block"], mesh)

        host = host_store()
        key = jax_random.PRNGKey(KEY_SEED)
        N = host.labels.shape[0]
        idx = torch.cat([torch.arange(N, dtype=torch.int32),
                         torch.zeros((-N) % world, dtype=torch.int32)])
        for name, mode, dtype, int8, metric, n, k in CASES:
            cfg = case_cfg(mode, dtype, metric)
            model = port_model(cfg, inputs["weights"][name])
            store = device_store_for(cfg, host, "cpu")
            qvars = inputs["qvars"] if int8 else None
            embed = pod_eval.make_sharded_embed_table_fn(model, cfg, mesh, qvars=qvars,
                                                         embed_batch=EMBED_BATCH)
            out[f"table_{name}"] = embed(store, idx)[:N]
            out[f"pod_{name}"] = pod_eval.pod_evaluate(model, store, cfg, mesh, key,
                                                       num_tasks=NUM_TASKS, n=n, k=k,
                                                       qvars=qvars, embed_batch=EMBED_BATCH)
            if rank == 0:  # the single-process path, in the same process
                out[f"embed_all_{name}"] = nshot.embed_all(model, store, cfg,
                                                           batch_size=EMBED_BATCH, qvars=qvars)
                out[f"single_{name}"] = nshot.evaluate(
                    model, store, cfg, key, num_tasks=pod_eval.pod_num_tasks(NUM_TASKS, world),
                    n=n, k=k, qvars=qvars, embed_batch=EMBED_BATCH)

        table = inputs["table"]
        utts, counts = torch.from_numpy(host.speaker_utts), torch.from_numpy(host.speaker_counts)
        tasks = pod_eval.pod_num_tasks(NUM_TASKS, world)
        out["scorer"] = pod_eval.make_sharded_task_scorer(mesh, tasks, 1, 3)(
            table, utts, counts, key)
        w, b = inputs["head"]
        for metric in ("weighted_l1", "uniform_euclidean"):
            scorer = pod_eval.make_sharded_siamese_scorer(mesh, tasks, 2, 3, metric)
            out[f"scorer_{metric}"] = scorer(table, w[metric], b, utts, counts, key)
        cfg = case_cfg("classifier", "float32", None)
        model = port_model(cfg, inputs["weights"]["float32"])
        store = device_store_for(cfg, host, "cpu")
        out["error_divide"] = _error(lambda: pod_eval.make_sharded_task_scorer(
            mesh, NUM_TASKS, 1, 3))
        out["error_k"] = _error(lambda: pod_eval.pod_evaluate(
            model, store, cfg, mesh, key, num_tasks=NUM_TASKS, n=1, k=SPEAKERS + 1))
        out["error_n"] = _error(lambda: pod_eval.pod_evaluate(
            model, store, cfg, mesh, key, num_tasks=NUM_TASKS, n=UTTS, k=3))
        out["error_key"] = _error(lambda: pod_eval.pod_evaluate(
            model, store, cfg, mesh, torch.Generator(), num_tasks=NUM_TASKS, n=1, k=3))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def jax_case(mode, dtype, metric, inits):
    """The JAX model, state, config and variables of one case; the
    classifier's cases share one f32 init (``inits``, by mode and metric)."""
    cfg = case_cfg(mode, dtype, metric)
    jcfg = jax_config(cfg)
    x = jnp.zeros((1, cfg.data.model_length, 1))
    def build(jcfg):
        if mode == "siamese":
            return JaxSiamese(jcfg.encoder, jcfg.siamese)
        return JaxClassifier(jcfg.encoder, num_classes=SPEAKERS)

    jmodel = build(jcfg)
    if (mode, metric) not in inits:
        args = (jax.random.PRNGKey(3), x, x) if mode == "siamese" else (jax.random.PRNGKey(2), x)
        v = randomize_bn(build(jax_config(case_cfg(mode, "float32", metric))).init(*args), 4)
        if mode == "siamese":
            v["params"]["head"]["bias"] = np.array([0.25], np.float32)
        inits[mode, metric] = v
    variables = inits[mode, metric]
    state = jstate.init_state(variables["params"], variables["batch_stats"],
                              jstate.make_optimizer(), 1e-3)
    return cfg, jcfg, jmodel, state, variables


@pytest.fixture(scope="module")
def jax_side():
    """Both packages' weights for every case (the JAX init, carried across
    by ``from_flax``), the JAX qvars, the distances' inputs and a shared
    table with the heads that score it."""
    host = host_store()
    jstore = jsteps.device_store_for(jax_config(case_cfg("classifier", "float32", None)),
                                     JaxAudioStore(**dataclasses.asdict(host)))
    cases, weights, inits = {}, {}, {}
    for name, mode, dtype, int8, metric, n, k in CASES:
        cfg, jcfg, jmodel, state, variables = jax_case(mode, dtype, metric, inits)
        cases[name] = (cfg, jcfg, jmodel, state)
        weights[name] = from_flax(variables, cfg.encoder)
    _, jcfg32, _, state32 = cases["float32"]
    jqvars = jq.quantize_from_store(state32, jcfg32, jstore, n_cal=8)
    rng = np.random.default_rng(21)
    nq, ns, d = QS
    q = rng.standard_normal((nq, d)).astype(np.float32)
    s = rng.standard_normal((ns, d)).astype(np.float32)
    table = rng.standard_normal((SPEAKERS * UTTS, 16)).astype(np.float32)
    head_w = {m: rng.standard_normal((16 if m == "weighted_l1" else 1, 1)).astype(np.float32)
              for m in ("weighted_l1", "uniform_euclidean")}
    return dict(host=host, jstore=jstore, cases=cases, weights=weights, jqvars=jqvars,
                q=q, s=s, table=table, head_w=head_w, head_b=np.float32(0.3))


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every rank's results of one world-3 run on gloo."""
    tmp = tmp_path_factory.mktemp("pod_ranks")
    j = jax_side
    torch.save({
        "weights": j["weights"],
        "qvars": qvars_from_numpy(jax.tree_util.tree_map(np.asarray, j["jqvars"]), "cpu"),
        "q": torch.from_numpy(j["q"]), "s": torch.from_numpy(j["s"]),
        "table": torch.from_numpy(j["table"]),
        "head": ({m: torch.from_numpy(w).reshape(-1) for m, w in j["head_w"].items()},
                 torch.tensor(j["head_b"])),
    }, tmp / "inputs.pt")
    spawn(_pod_rank, WORLD, tmp)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh3():
    return jmesh.make_mesh({"data": WORLD})


def test_the_sharded_distances_equal_the_dense_matrix_and_jax(ranks, jax_side, mesh3):
    q, s = jax_side["q"], jax_side["s"]
    dense = tdist.pairwise_sq_euclidean(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    jq_, js_ = jnp.asarray(q), jnp.asarray(s)
    want_sharded = np.asarray(jsd.sharded_sq_euclidean(jq_, js_, mesh3))
    want_ring = np.asarray(jsd.ring_sq_euclidean(jq_, js_, mesh3))
    want_nearest = np.asarray(jsd.sharded_nearest_support(jq_, js_, mesh3))
    cols = s.shape[0] // WORLD
    for r, got in enumerate(ranks):
        for name, want in (("sharded", want_sharded), ("ring", want_ring)):
            np.testing.assert_allclose(got[name].numpy(), dense, rtol=DIST_TOL, atol=DIST_TOL)
            np.testing.assert_allclose(got[name].numpy(), want, rtol=DIST_TOL, atol=DIST_TOL)
        block = dense[:, r * cols:(r + 1) * cols]
        np.testing.assert_allclose(got["ring_block"].numpy(), block, rtol=DIST_TOL,
                                   atol=DIST_TOL)
        np.testing.assert_allclose(got["sharded_block"].numpy(), block, rtol=DIST_TOL,
                                   atol=DIST_TOL)
        np.testing.assert_array_equal(got["nearest"].numpy(), dense.argmin(1))
        np.testing.assert_array_equal(got["nearest"].numpy(), want_nearest)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_the_pod_table_is_embed_alls_row_for_row(ranks, case):
    want = ranks[0][f"embed_all_{case}"]
    assert want.shape == (SPEAKERS * UTTS, 16)
    for got in ranks:
        assert torch.equal(got[f"table_{case}"], want), case


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("case", ["float32", "bfloat16", "int8", "weighted_l1"])
def test_the_pod_table_matches_jaxs(ranks, jax_side, mesh3, case):
    cfg, jcfg, jmodel, state = jax_side["cases"][case]
    qvars = jax_side["jqvars"] if case == "int8" else None
    N = SPEAKERS * UTTS
    idx = jnp.asarray(np.concatenate([np.arange(N), np.zeros((-N) % WORLD)]).astype(np.int32))
    fn = jpod.make_sharded_embed_table_fn(jmodel, jcfg, mesh3, qvars=qvars)
    want = np.asarray(fn(state, jax_side["jstore"], idx))[:N]
    got = ranks[1][f"table_{case}"].numpy()
    if case == "bfloat16":
        assert _cosine(got, want).min() >= BF16_MIN_COSINE
    elif case == "int8":
        assert _cosine(got, want).min() >= INT8_MIN_COSINE
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_pod_evaluate_equals_single_device_evaluate(ranks, case):
    want = ranks[0][f"single_{case}"]
    assert isinstance(want, float) and 0.0 < want < 1.0
    assert [r[f"pod_{case}"] for r in ranks] == [want] * WORLD


def _class_scores(table, tasks, metric, w, b, n, k):
    """Each task's class scores in float64: the mean euclidean distance, or
    the head's logits (``metric``), of the query to each class's supports."""
    t = torch.from_numpy(table).double()
    q = t[torch.from_numpy(tasks.query_idx).long()]
    s = t[torch.from_numpy(tasks.support_idx).long()].reshape(len(q), k * n, -1)
    if metric is None:
        d = torch.sqrt(((q[:, None] - s) ** 2).sum(-1))
    else:
        d = tdist.head_scores(q, s, torch.from_numpy(w).double(), float(b), metric)
    return d.reshape(len(q), k, n).mean(-1)


@pytest.mark.parametrize("metric", [None, "weighted_l1", "uniform_euclidean"])
def test_the_pod_scorers_match_jaxs(ranks, jax_side, mesh3, metric):
    """One table, one key: the port's pod accuracy against the JAX pod
    scorer's; a differing count of correct tasks is allowed only up to the
    tasks that are near-ties in float64."""
    host, table = jax_side["host"], jax_side["table"]
    tasks_n = pod_eval.pod_num_tasks(NUM_TASKS, WORLD)
    n = 1 if metric is None else 2
    key = jax.random.PRNGKey(KEY_SEED)
    utts, counts = jnp.asarray(host.speaker_utts), jnp.asarray(host.speaker_counts)
    if metric is None:
        want = float(jpod.make_sharded_task_scorer(mesh3, tasks_n, n, 3)(
            jnp.asarray(table), utts, counts, key))
        got = [r["scorer"] for r in ranks]
        w = None
    else:
        w = jax_side["head_w"][metric]
        want = float(jpod.make_sharded_siamese_scorer(mesh3, tasks_n, n, 3, metric)(
            jnp.asarray(table), jnp.asarray(w), jax_side["head_b"], utts, counts, key))
        got = [r[f"scorer_{metric}"] for r in ranks]
    assert got == [got[0]] * WORLD
    tasks = jax_random.nshot_tasks(jax_random.PRNGKey(KEY_SEED), host.speaker_utts,
                                   host.speaker_counts, tasks_n, n, 3)
    scores = _class_scores(table, tasks, metric, w, jax_side["head_b"], n, 3)
    top2 = scores.sort(dim=-1).values[:, :2]
    gap = (top2[:, 1] - top2[:, 0]) / top2.abs().max(dim=-1).values.clamp(min=1e-12)
    ties = int((gap <= NEAR_TIE).sum())
    assert abs(got[0] - want) * tasks_n <= ties + 1e-6, (got[0], want, ties)
    assert 0.0 < want < 1.0


def test_the_rounding_and_the_refusals_are_jaxs(ranks, jax_side, mesh3):
    assert pod_eval.pod_num_tasks(NUM_TASKS, WORLD) == 498
    assert pod_eval.pod_num_tasks(1, WORLD) == WORLD
    with pytest.raises(ValueError) as divide:
        jpod.make_sharded_task_scorer(mesh3, NUM_TASKS, 1, 3)
    cfg, jcfg, jmodel, state = jax_side["cases"]["float32"]
    with pytest.raises(ValueError) as too_many:
        jpod.pod_evaluate(jmodel, state, jax_side["jstore"], jcfg, mesh3,
                          jax.random.PRNGKey(KEY_SEED), num_tasks=NUM_TASKS, n=1,
                          k=SPEAKERS + 1)
    for got in ranks:
        assert got["error_divide"] == str(divide.value)
        assert got["error_k"] == str(too_many.value)
        assert got["error_n"] == f"n+1={UTTS + 1} exceeds max utterances/speaker ({UTTS})"
        assert "jax_random key" in got["error_key"]
