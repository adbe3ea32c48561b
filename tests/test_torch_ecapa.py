"""ECAPA-TDNN in the port (``voicemap_tpu_torch/models/ecapa.py``) on the CPU,
against the benchmark's plain reference (``portbench/reference/ecapa_tdnn.py``,
float32, written from the published description), on the reference's seeded
weights at a small size: 256 channels, scale 8, 40 mels, 1 s.

- the plain forward (``F.conv1d``) and the fast path's CPU fallback (B6's
  plain version, the 1×1 TDNNs as one GEMM over all rows, ASP's context
  folded into ``[h, u_hi, u_lo]``), and the fast path with B8's plain
  version standing in for every TDNN, each within ``TOL`` of the reference;
- each mechanism dropped from the port in turn (Res2Net's hierarchical add,
  the SE gate, the global context, the pooled std) puts it far outside
  ``TOL``: the comparison sees each one;
- in bf16 the fast path keeps to the reference within ``BF16_TOL``;
- the preset's published widths and parameter count;
- ``eval.nshot.embed_rows`` on a 16 kHz store, fast or not, and the embed
  CLI's ``--mode ecapa_tdnn``; the spans under a profiler;
- the benchmark cell at a tiny size, traced, in a child process (the
  benchmark refuses a process that has JAX loaded, as this one has).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import data, program
from portbench.kinds import embed_ecapa
from portbench.reference import ecapa_tdnn as ref
from voicemap_tpu_torch import config as C
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models import ecapa, fast_infer
from voicemap_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
SEED = 2**31 + 11
ROWS = 4
# f32 against f32: the two differ in summation order and in the front end's
# route (an rfft, or B6's DFT matmul, against the reference's rfft), and the
# pooled statistics' BatchNorm divides by their spread over utterances,
# which is several times smaller than their values; readings ~1e-5.
TOL = 1e-4
# bf16 activations and weights against f32: ~0.2% a rounding over some 26
# TDNNs, amplified as above; readings 0.01-0.03 (the benchmark cell's
# limits are set on the card at the published widths).
BF16_TOL = 0.08


def small_config(compute_dtype: str = "float32") -> dict:
    doc = json.loads((REPO / "portbench/configs/ecapa_tdnn.json").read_text())
    doc["encoder"].update(channels=[256, 256, 256, 256, 768], se_channels=32,
                          attention_channels=32, embedding_dim=48, compute_dtype=compute_dtype)
    doc["data"]["seconds"] = 1.0
    doc["mel"]["n_mels"] = 40
    return doc


def port_model(doc: dict) -> ecapa.EcapaClassifier:
    return embed_ecapa.model(embed_ecapa.experiment_config(doc), doc, 5, SEED, "cpu")


@pytest.fixture(scope="module")
def f32():
    """The small config in f32, the port holding the reference's weights,
    seeded waveforms and the reference's embeddings of them."""
    doc = small_config()
    spec = data.StoreSpec(ROWS, ROWS, 1.0, 1.0)
    raw, _ = data.query_pool(spec, SEED, ROWS, 1.0, "cpu")
    x = ref.preprocess(raw, doc)
    want = ref.embed(ref.weights(doc, SEED, "cpu"), x, doc)
    return doc, port_model(doc), x, want


def rel_err(got, want) -> float:
    return float(ref.relative_errors(got, want).max())


def test_plain_forward_matches_the_reference(f32):
    _, model, x, want = f32
    assert rel_err(model.embed(x[..., None]), want) < TOL


def test_fast_path_cpu_fallback_matches_the_reference(f32):
    _, model, x, want = f32
    assert rel_err(ecapa.fast_embed(model.encoder, x[..., None]), want) < TOL


def test_fast_path_through_b8s_plain_version_matches_the_reference(f32, monkeypatch):
    """Every TDNN through ``conv_blockn``'s plain version (B8's layout:
    the packed taps, SAME zero padding by row, the 1×1 TDNNs as one row of
    B·T, the folded context), multiplying in f32."""
    _, model, x, want = f32
    calls = []
    blockn = fast_infer.conv_blockn

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return blockn(*a, **kw)

    monkeypatch.setattr(fast_infer, "takes", lambda k, d, pool, cdt: True)
    monkeypatch.setattr(fast_infer, "conv_blockn", counted)
    assert rel_err(ecapa.fast_embed(model.encoder, x[..., None]), want) < TOL
    assert len(calls) == 30
    assert calls[0] == (5, 40, 256) and calls[-1] == (1, 768 + 2 * 32, 32)


def _no_hierarchy(convs, y, tdnn):
    parts = y.chunk(len(convs) + 1, dim=2)
    return torch.cat([parts[0]] + [tdnn(c, parts[i]) for i, c in enumerate(convs, start=1)],
                     dim=2)


_ATTENTIVE_STATS = ecapa.attentive_stats


def _no_std(h, logits):
    pooled = _ATTENTIVE_STATS(h, logits).clone()
    pooled[:, pooled.shape[1] // 2:] = 0.0
    return pooled


MECHANISMS = {
    "res2net_hierarchy": ("res2net", _no_hierarchy),
    "se_gate": ("se_gate", lambda se, y: torch.ones(y.shape[0], y.shape[2])),
    "global_context": ("global_stats",
                       lambda h: (torch.zeros(h.shape[0], h.shape[2]),) * 2),
    "pooled_std": ("attentive_stats", _no_std),
}


@pytest.mark.parametrize("mechanism", sorted(MECHANISMS))
@pytest.mark.parametrize("fast", [False, True])
def test_a_dropped_mechanism_fails_the_comparison(f32, monkeypatch, mechanism, fast):
    _, model, x, want = f32
    name, dropped = MECHANISMS[mechanism]
    monkeypatch.setattr(ecapa, name, dropped)
    got = ecapa.fast_embed(model.encoder, x[..., None]) if fast else model.embed(x[..., None])
    assert rel_err(got, want) > 100 * TOL


def test_bf16_fast_path_keeps_to_the_reference(f32):
    doc, _, x, want = f32
    model = port_model(small_config("bfloat16"))
    assert rel_err(ecapa.fast_embed(model.encoder, x[..., None]), want) < BF16_TOL
    assert rel_err(model.embed(x[..., None]), want) < BF16_TOL


def test_the_preset_has_the_published_widths_and_parameter_count():
    cfg = C.PORT_PRESETS["ecapa_tdnn"]()
    e, m, d = cfg.ecapa, cfg.mel, cfg.data
    assert (cfg.mode, e.channels, e.kernel_sizes, e.dilations) == (
        "ecapa_tdnn", (1024, 1024, 1024, 1024, 3072), (5, 3, 3, 3, 1), (1, 2, 3, 4, 1))
    assert (e.res2net_scale, e.se_channels, e.attention_channels, e.embedding_dim) == (
        8, 128, 128, 192)
    assert (m.n_mels, m.n_fft, m.win_length, m.hop_length, m.fmin, m.fmax) == (
        80, 400, 400, 160, 0.0, 8000.0)
    assert (d.sample_rate, d.downsampling, d.whiten_rms, d.seconds) == (16000, 1, None, 3.0)
    assert "ecapa_tdnn" not in C.PRESETS  # the JAX package's copy stays as it is
    model = ecapa.EcapaTDNN(e, m, d.sample_rate, device="meta")
    tdnn = lambda cin, cout, k: cin * cout * k + cout + 2 * cout  # noqa: E731
    block = (2 * tdnn(1024, 1024, 1) + 7 * tdnn(128, 128, 3)
             + (1024 * 128 + 128) + (128 * 1024 + 1024))
    want = (tdnn(80, 1024, 5) + 3 * block + tdnn(3072, 3072, 1) + tdnn(9216, 128, 1)
            + (128 * 3072 + 3072) + 2 * 6144 + (6144 * 192 + 192))
    assert sum(p.numel() for p in model.parameters()) == want == 20_767_552
    # the config file the benchmark runs is the preset
    doc = json.loads((REPO / "portbench/configs/ecapa_tdnn.json").read_text())
    assert embed_ecapa.experiment_config(doc) == cfg and doc["reduced"] == []


@pytest.mark.parametrize("fast", [False, True])
def test_embed_rows_through_the_entry_point(f32, fast):
    """``embed_rows`` fetches offset-0 windows ÷ 32768 (B1's plain version at
    downsampling 1, no whitening) and embeds them by the chosen route."""
    doc, model, _, _ = f32
    cfg = embed_ecapa.experiment_config(doc)
    store = program.device_store(data.StoreSpec(2, 6, 1.2, 1.6), SEED, 1, "cpu")
    rows = torch.tensor([4, 0, 5, 2], dtype=torch.int32)
    got = nshot.embed_rows(model, store, cfg, rows, batch_size=3, fast=fast)
    x = ref.preprocess(store.audio[rows.long(), :16000], doc)
    want = ref.embed(ref.weights(doc, SEED, "cpu"), x, doc)
    assert got.shape == (4, 48) and rel_err(got, want) < TOL


def test_spans_name_each_stage_with_its_rows(f32):
    doc, model, x, _ = f32
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        ecapa.fast_embed(model.encoder, x[..., None])
    records = profiling.spans()
    profiling.clear_spans()
    names = [r.name for r in records]
    assert names == ["embed", "ecapa.frontend", "ecapa.layer1", "ecapa.block.1",
                     "ecapa.block.2", "ecapa.block.3", "ecapa.mfa", "ecapa.asp", "ecapa.head"]
    assert all(r.rows == ROWS for r in records)
    assert all(r.parent == "embed" for r in records[1:])


def test_embed_cli_mode_ecapa_tdnn(tmp_path, capsys):
    """``experiments/embed.py --mode ecapa_tdnn`` on two WAV files at the
    preset's widths (random init); the int8 options are refused."""
    import wave

    from voicemap_tpu_torch.experiments import embed

    paths = []
    for i, seconds in enumerate((0.4, 0.55)):
        p = tmp_path / f"u{i}.wav"
        samples = (np.sin(np.arange(int(16000 * seconds)) * 0.05 * (i + 1)) * 3000).astype(np.int16)
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(samples.tobytes())
        paths.append(str(p))
    out = tmp_path / "e.npz"
    table, got_paths = embed.main(paths + ["--mode", "ecapa_tdnn", "--device", "cpu",
                                           "--seconds", "0.5", "--out", str(out)])
    assert table.shape == (2, 192) and np.isfinite(table).all() and got_paths == paths
    assert np.load(out)["embeddings"].shape == (2, 192)
    with pytest.raises(SystemExit, match="no int8 path"):
        embed.main(paths + ["--mode", "ecapa_tdnn", "--device", "cpu", "--int8"])


# The ECAPA cell traced once at a tiny size, then one untraced run with the
# fp8 control (``--variant int8``): the two result lines as one JSON line.
CHILD = r"""
import json, sys
from pathlib import Path
from portbench import run
from portbench.tests.test_portbench_ecapa import make_ecapa_root
root = make_ecapa_root(Path(sys.argv[1]))
out = []
for argv in (["--trace", "1"], ["--trace", "0", "--variant", "int8"]):
    assert run.main(["--workload", "ecapa_tdnn.embed_bulk_16k", "--seed", "2147483659",
                     "--seconds", "0.2"] + argv, root=root, device="cpu") == 0
"""


def test_the_benchmark_cell_runs_tiny_and_its_control_fails(tmp_path):
    p = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], cwd=REPO,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 0, p.stderr[-3000:]
    traced, control = [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]
    assert traced["correct"] and not control["correct"], (traced["checks"], control["checks"])
    assert {"res2block_roofline.ecapa", "mfa_roofline.ecapa", "asp_roofline.ecapa"} <= set(
        traced["metrics"])
