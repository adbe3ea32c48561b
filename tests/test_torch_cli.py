"""The port's experiment CLIs (``voicemap_tpu_torch/experiments``) on the CPU.

Each parser holds every option of its JAX script (``experiments/*.py``) with
the same default, choices and type, and ``--device`` besides (embed's
``--mode`` also takes the port's own ``PORT_MODES`` after the JAX script's). Each ``main``
runs end to end with ``--device cpu`` on a tiny synthetic corpus: train,
then resume; the protocol, its int8 gate, the k sweep with verification;
embed in int8 with its calibration saved, then served from it (equal
tables); the PCA picture; the siamese net trained and put through the
protocol. The refusals exit as the JAX scripts' do, and the CLIs run with
matplotlib blocked."""

import argparse
import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voicemap_tpu_torch.data.synthetic import SyntheticSpec, generate_corpus
from voicemap_tpu_torch.eval import protocol
from voicemap_tpu_torch.experiments import (
    embed, evaluate, train_classifier, train_siamese, visualize_embeddings,
)
from voicemap_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
PORT = {"train_classifier": train_classifier, "train_siamese": train_siamese,
        "evaluate": evaluate, "embed": embed, "visualize_embeddings": visualize_embeddings}
TINY = ["--device", "cpu", "--filters", "8", "--embedding-dim", "8"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}",
                                                  REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parser_of(parse, monkeypatch):
    """The ``ArgumentParser`` that ``parse()`` builds, and its result."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen.append(self)
        return real(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    ns = parse()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return seen[0], ns


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(PORT))
def test_every_jax_option_with_its_default(name, monkeypatch, tmp_path):
    """The JAX script parsed with no arguments (``sys.argv``), the port's
    with ``[]``: the same options and the same values, ``--device`` extra."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    jax_parser, jax_ns = _parser_of(_jax_script(name).parse_args, monkeypatch)
    parser, ns = _parser_of(lambda: PORT[name].parse_args([]), monkeypatch)
    want, got = _options(jax_parser), _options(parser)
    assert set(got) - set(want) == {"device"}
    assert got.pop("device")[1:3] == ("cuda", ["cuda", "cpu"])
    if name == "embed":  # the port's own modes follow the JAX script's choices
        mode = got["mode"]
        assert tuple(mode[2][len(want["mode"][2]):]) == embed.PORT_MODES
        got["mode"] = mode[:2] + (mode[2][:len(want["mode"][2])],) + mode[3:]
    assert got == want
    assert {k: v for k, v in vars(ns).items() if k != "device"} == vars(jax_ns)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """train-clean-100: 6 speakers × 4; dev-clean and test-clean: 12 × 7
    (3.1–3.5 s, so that the manifest's 3 s fragments fit)."""
    root = tmp_path_factory.mktemp("cli_corpus")
    generate_corpus(str(root), ("train-clean-100",),
                    SyntheticSpec(n_speakers=6, utterances_per_speaker=4, min_seconds=3.1,
                                  max_seconds=3.5, seed=3))
    generate_corpus(str(root), ("dev-clean", "test-clean"),
                    SyntheticSpec(n_speakers=12, utterances_per_speaker=7, min_seconds=3.1,
                                  max_seconds=3.5, seed=4))
    return root


@pytest.fixture(scope="module")
def trained(corpus):
    """A classifier checkpoint: 4 steps (under ``--profile``), then resumed
    to 6 → ``(root, [(history, stdout), (history, stdout)])``."""
    out = []
    for steps in (4, 6):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            history = train_classifier.main(
                TINY + ["--data-root", str(corpus), "--subsets", "train-clean-100",
                        "--val-subsets", "dev-clean", "--num-steps", str(steps),
                        "--evaluate-every", "2", "--batch-size", "8", "--num-eval-tasks", "20",
                        "--checkpoint-dir", str(corpus / "ckpt"),
                        "--log-path", str(corpus / "m.jsonl")]
                + (["--profile", str(corpus / "trace")] if steps == 4 else []))
        out.append((history, buf.getvalue()))
    return corpus, out


def test_train_then_resume(trained):
    root, ((first, out1), (second, out2)) = trained
    assert [r["step"] for r in first] == [2, 4] and [r["step"] for r in second] == [6]
    assert "resumed from step" not in out1 and "resumed from step 4" in out2
    assert "experiment: classifier__filters_8__embed_8" in out1
    assert all(np.isfinite(r["loss"]) and 0 <= r["val_1-shot_acc"] <= 1 for r in first + second)
    assert (root / "ckpt" / "best").is_dir() and (root / "trace" / "trace.json").is_file()
    assert len((root / "m.jsonl").read_text().splitlines()) == 3


def _records(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_the_protocol_on_the_checkpoint(trained, capsys):
    root, _ = trained
    base = TINY + ["--data-root", str(root), "--checkpoint-dir", str(root / "ckpt"),
                   "--protocol", "--allow-corpus-mismatch"]
    for extra in ([], ["--int8"]):
        returned = evaluate.main(base + extra)
        out = capsys.readouterr().out
        assert "sizing head to checkpoint: 6 classes (corpus has 12)" in out
        assert "restored best checkpoint at step" in out
        recs = _records(out)
        assert recs == returned and len(recs) == 6
        m = protocol.load_manifest()
        assert [r["entry"] for r in recs] == [e["name"] for e in m["entries"]] + [
            e["name"] for e in m["verification"]["entries"]]
        for r in recs:
            assert r["int8"] is bool(extra) and r["corpus_verified"] is False
            assert r["key_stream"] == "threefry2x32-partitionable (numpy replay)"
            for key in ("accuracy", "eer", "auc"):
                assert key not in r or 0.0 <= r[key] <= 1.0
    verdict = evaluate.main(base + ["--int8-gate"])
    printed = _records(capsys.readouterr().out)
    assert printed == [verdict] and verdict["int8_accuracy_gate"] == "pass"
    assert [c["metric"] for c in verdict["checks"]] == ["accuracy"] * 4 + ["eer", "auc"] * 2


def test_the_gate_exits_2_on_fail(trained, monkeypatch, capsys):
    root, _ = trained
    monkeypatch.setattr(protocol, "int8_accuracy_gate",
                        lambda *a, **k: {"int8_accuracy_gate": "fail", "checks": []})
    with pytest.raises(SystemExit) as e:
        evaluate.main(TINY + ["--data-root", str(root), "--protocol", "--int8-gate"])
    assert e.value.code == 2
    assert _records(capsys.readouterr().out)[0]["int8_accuracy_gate"] == "fail"


def test_the_k_sweep_and_verification(trained, tmp_path, capsys):
    root, _ = trained
    out_prefix = str(tmp_path / "sweep")
    got = evaluate.main(TINY + ["--data-root", str(root), "--checkpoint-dir", str(root / "ckpt"),
                                "--k-sweep", "2", "14", "--fast", "--num-tasks", "50",
                                "--verification", "100", "--sweep-out", out_prefix])
    out = capsys.readouterr().out
    points = got["sweep"]
    assert _records(out) == points and len(points) == 2 * 13
    assert [p["k_way"] for p in points if "skipped" in p] == [13, 14, 13, 14]
    assert all(0 <= p["accuracy"] <= 1 for p in points if "accuracy" in p)
    meta = json.loads(Path(out_prefix + ".json").read_text())
    assert meta["points"] == points and meta["int8"] is False
    assert Path(out_prefix + ".png").is_file()
    assert "verification over 100 pairs: EER" in out
    assert 0 <= got["verification"]["eer"] <= 1 and 0 <= got["verification"]["auc"] <= 1


def test_adhoc_evaluate_uses_the_seeds_tasks(trained, capsys):
    """The ad-hoc accuracy is ``nshot.evaluate`` at ``jax_random.PRNGKey(--seed)``."""
    root, _ = trained
    argv = TINY + ["--data-root", str(root), "--checkpoint-dir", str(root / "ckpt"),
                   "--num-tasks", "40", "--seed", "3"]
    a, b = evaluate.main(argv), evaluate.main(argv)
    c = evaluate.main(argv[:-1] + ["4"])
    out = capsys.readouterr().out
    assert a == b and 0 <= a["accuracy"] <= 1
    assert "1-shot 5-way accuracy over 40 tasks on ['dev-clean']" in out
    assert a["stderr"] == pytest.approx(np.sqrt(max(a["accuracy"] * (1 - a["accuracy"]),
                                                    1e-12) / 40))
    assert set(c) == set(a)


def test_embed_int8_then_from_the_saved_calibration(trained, tmp_path, capsys):
    root, _ = trained
    base = TINY + ["--data-root", str(root), "--checkpoint-dir", str(root / "ckpt"),
                   "--subsets", "dev-clean"]
    q = str(tmp_path / "q.npz")
    a, paths = embed.main(base + ["--int8", "--save-qvars", q, "--out", str(tmp_path / "a.npz")])
    b, _ = embed.main(base + ["--qvars", q, "--out", str(tmp_path / "b.npz")])
    c, _ = embed.main(base + ["--out", str(tmp_path / "c.npz"), "--pipeline", "streaming"])
    out = capsys.readouterr().out
    assert "wrote int8 artifact" in out and "loaded artifact" in out
    assert a.shape == (84, 8) and np.array_equal(a, b) and np.isfinite(c).all()
    z = np.load(tmp_path / "a.npz")
    assert np.array_equal(z["embeddings"], a) and list(z["paths"]) == paths
    assert all(Path(p).is_file() for p in paths)
    # explicit files: an in-memory store of one speaker
    files, _ = embed.main(TINY + ["--out", str(tmp_path / "f.npz")] + paths[:3])
    assert files.shape == (3, 8) and np.isfinite(files).all()
    # the ad-hoc evaluation served from the saved calibration, and calibrated
    # on the eval store: the same tables, so the same tasks score the same
    adhoc = TINY + ["--data-root", str(root), "--checkpoint-dir", str(root / "ckpt"),
                    "--num-tasks", "40"]
    from_file = evaluate.main(adhoc + ["--qvars", q])
    calibrated = evaluate.main(adhoc + ["--int8"])
    out = capsys.readouterr().out
    assert "int8 serving path: loaded artifact" in out
    assert "int8 serving path: calibrated on the eval store" in out
    assert from_file == calibrated and 0 <= from_file["accuracy"] <= 1


def test_visualize(trained, tmp_path, capsys):
    root, _ = trained
    got = visualize_embeddings.main(TINY + ["--data-root", str(root), "--checkpoint-dir",
                                            str(root / "ckpt"), "--out", str(tmp_path / "v")])
    z = np.load(tmp_path / "v.npz")
    assert z["embeddings"].shape == (84, 8) and z["pca2d"].shape == (84, 2)
    assert np.array_equal(z["labels"], got["labels"]) and (tmp_path / "v.png").is_file()
    assert "restored step" in capsys.readouterr().out
    # the projection is the SVD's: centred, variance on the first axis first
    var = z["pca2d"].var(axis=0)
    assert var[0] >= var[1]


def test_the_siamese_net_trains_and_goes_through_the_protocol(trained, capsys):
    root, _ = trained
    ckpt = str(root / "siamese_ckpt")
    history = train_siamese.main(TINY + ["--data-root", str(root), "--distance-metric",
                                         "weighted_l1", "--num-steps", "4", "--evaluate-every",
                                         "4", "--batch-size", "8", "--num-eval-tasks", "20",
                                         "--checkpoint-dir", ckpt,
                                         "--log-path", str(root / "s.jsonl")])
    assert [r["step"] for r in history] == [4] and np.isfinite(history[0]["loss"])
    recs = evaluate.main(TINY + ["--data-root", str(root), "--mode", "siamese",
                                 "--distance-metric", "weighted_l1", "--checkpoint-dir", ckpt,
                                 "--protocol", "--allow-corpus-mismatch"])
    assert len(recs) == 6 and all(0 <= r.get("accuracy", r.get("eer")) <= 1 for r in recs)
    assert "sizing head" not in capsys.readouterr().out  # a Dense(1) head says nothing


REFUSALS = [
    (["--protocol", "--qvars", "q.npz"], "--qvars is for the ad-hoc path"),
    (["--int8-gate"], "--int8-gate requires --protocol"),
    (["--protocol", "--k-sweep", "2", "5"], "--protocol runs the manifest's pinned"),
    (["--k-sweep", "5", "2"], "--k-sweep needs 2 <= KMIN <= KMAX"),
]


@pytest.mark.parametrize("extra,message", REFUSALS)
def test_evaluate_refuses_as_the_jax_script(trained, extra, message, monkeypatch, tmp_path):
    """The same option sets refused with the same message (the JAX script
    runs with JAX on the CPU, on the same corpus, at the same widths)."""
    root, _ = trained
    monkeypatch.chdir(tmp_path)
    common = ["--data-root", str(root), "--filters", "8", "--embedding-dim", "8"]
    with pytest.raises(SystemExit) as port:
        evaluate.main(["--device", "cpu"] + common + extra)
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + common + extra)
    with pytest.raises(SystemExit) as ref:
        _jax_script("evaluate").main()
    assert port.value.code == ref.value.code and str(port.value.code).startswith(message)


@pytest.mark.parametrize("argv,message", [
    ([], "give audio files or --subsets"),
    (["--pipeline", "streaming", "x.wav"], "--pipeline streaming needs --subsets"),
])
def test_embed_refuses_as_the_jax_script(argv, message, monkeypatch):
    with pytest.raises(SystemExit) as port:
        embed.main(["--device", "cpu"] + argv)
    monkeypatch.setattr(sys, "argv", ["embed.py"] + argv)
    with pytest.raises(SystemExit) as ref:
        _jax_script("embed").main()
    assert port.value.code == ref.value.code and str(port.value.code).startswith(message)


def test_the_clis_run_with_matplotlib_blocked(trained, tmp_path, monkeypatch, capsys):
    """The card's machine has no matplotlib: the sweep's JSON and the PCA's
    ``.npz`` are written, the figures are not, and a line says so."""
    root, _ = trained
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    prefix = str(tmp_path / "sweep")
    evaluate.main(TINY + ["--data-root", str(root), "--k-sweep", "2", "3", "--num-tasks", "10",
                          "--sweep-out", prefix])
    visualize_embeddings.main(TINY + ["--data-root", str(root), "--out", str(tmp_path / "v")])
    out = capsys.readouterr().out
    assert Path(prefix + ".json").is_file() and not Path(prefix + ".png").exists()
    assert (tmp_path / "v.npz").is_file() and not (tmp_path / "v.png").exists()
    assert out.count("matplotlib is not installed") == 2


def test_each_cli_runs_as_a_module():
    code = ("import runpy, sys\n"
            "for m in ('train_classifier', 'train_siamese', 'evaluate', 'embed',\n"
            "          'visualize_embeddings'):\n"
            "    sys.argv = [m, '--help']\n"
            "    try:\n"
            "        runpy.run_module('voicemap_tpu_torch.experiments.' + m, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (m, e.code)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("\n  --device {cuda,cpu}") == 5 and proc.stdout.endswith("ok\n")


def test_step_timer_and_the_request_timer_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        profiling.single_request_latency(lambda: torch.zeros(1))
    with profiling.trace(None):
        pass
