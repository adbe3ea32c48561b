"""ECAPA-TDNN's training path in the port (``models/ecapa.train_forward``,
``train/steps.make_ecapa_train_step``, ``train/losses.aam_softmax``, ASP's
autograd functions in ``ops/cuda_asp``, ``fit(mode="ecapa_tdnn")``) on the
CPU, against the benchmark's plain training reference
(``portbench/reference/ecapa_tdnn_train.py``, float32, written from the
published description) at a small size: 64 channels, Res2Net scale 8, SE
and attention 16, 40 mels, 0.5 s windows, batch 8, 16 classes, float32, on
the reference's seeded weights.

- Three steps of ``make_ecapa_train_step``, each against the reference's
  ``train`` from the program's parameters, Adam moments and running
  statistics before that step: the loss, the clipped gradient and the
  running statistics within ``TOL``; and the parameters' change against the
  reference's Adam step (``adam_update``) on the program's clipped gradient
  within ``TOL``. (Step by step, and the update on one gradient, because
  the small model is sensitive: a 1e-5 change of its weights moves its
  gradients by ~0.3%, and Adam turns the rounding of a near-zero gradient
  element into a step of up to its learning rate, so two free-running
  trajectories part by more than rounding after a step or two.)
- Each control of the benchmark cell (``portbench/controls_ecapa_train``:
  the fp8 rounding and the detached global context) fails that comparison.
- ASP's closed-form backward, both modes, against autograd through the
  plain versions' formula; AAM against a transcription of SpeechBrain's
  formula, its cos ≤ cos(π − m) branch included; the spans; ``fit``.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from portbench import controls_ecapa_train, data, program
from portbench.kinds import train_ecapa
from portbench.reference import ecapa_tdnn as ref_model
from portbench.reference import ecapa_tdnn_train as ref
from voicemap_tpu_torch import config as C
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.ops import cuda_asp
from voicemap_tpu_torch.train import losses
from voicemap_tpu_torch.train.loop import fit
from voicemap_tpu_torch.train.state import init_state
from voicemap_tpu_torch.train.steps import make_ecapa_train_step
from voicemap_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
SEED = 2**31 + 29
CLASSES, BATCH, STEPS = 16, 8, 3
# f32 against f32, one step from the same state: summation orders differ
# (channels last against channels first, the folded context, the closed-form
# ASP backward); readings ~1e-7–3e-5.
TOL = 1e-4


def small_config() -> dict:
    doc = json.loads((REPO / "portbench/configs/ecapa_tdnn_train.json").read_text())
    doc["encoder"].update(channels=[64, 64, 64, 64, 192], se_channels=16,
                          attention_channels=16, embedding_dim=24, compute_dtype="float32")
    doc["data"]["seconds"] = 0.5
    doc["mel"]["n_mels"] = 40
    return doc


def traffic() -> dict:
    doc = json.loads((REPO / "portbench/traffic/train_aam_b512.json").read_text())
    doc["store"].update(speakers=CLASSES, utterances=2 * CLASSES, min_seconds=0.6,
                        max_seconds=1.0)
    doc["batch_size"] = BATCH
    return doc


def build(doc: dict, mix: dict, device="cpu"):
    """The port's model, train state and step on the reference's weights,
    as the benchmark's kind builds them."""
    cfg = train_ecapa.train_config(doc, mix)
    spec = data.StoreSpec.of(mix["store"])
    model = train_ecapa.ecapa_model(cfg, doc, spec.speakers, SEED, device)
    with torch.no_grad():
        model.head.weight.copy_(ref.head_weights(doc, spec.speakers, SEED, device)["head.weight"])
    t = cfg.train
    state = init_state(model, t.clipnorm, t.learning_rate, cfg.weight_decay)
    step, _ = make_ecapa_train_step(model, cfg)
    store = program.device_store(spec, SEED, 1, device)
    return cfg, spec, model, state, step, store


def snapshot(model, state) -> dict:
    """Parameters, Adam's moments and step, and BatchNorm's running
    statistics, by the reference's names."""
    params = train_ecapa.leaves(model)
    adam = state.optimizer.adam.state
    clone = lambda t: t.detach().clone()  # noqa: E731
    return {"params": {n: clone(p) for n, p in params.items()},
            "m": {n: clone(adam[p]["exp_avg"]) for n, p in params.items() if p in adam},
            "v": {n: clone(adam[p]["exp_avg_sq"]) for n, p in params.items() if p in adam},
            "step": state.step,
            "buffers": {n: clone(b) for n, b in model.encoder.named_buffers()
                        if n.endswith(("running_mean", "running_var"))},
            "grad": {n: clone(p.grad) for n, p in params.items() if p.grad is not None}}


def worst_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's ‖got − want‖ over the larger of ‖want‖ and the
    median leaf's norm."""
    names = [n for n in want if keep is None or n in keep]
    norms = {n: float(want[n].double().norm()) for n in names}
    median = sorted(norms.values())[len(norms) // 2]
    return max(float((got[n].double() - want[n].double()).norm()) / max(norms[n], median, 1e-30)
               for n in names)


def run_steps(doc, mix):
    """Three program steps → the snapshots before and after each, and the
    losses."""
    cfg, spec, model, state, step, store = build(doc, mix)
    gen = torch.Generator().manual_seed(data.sub_seed(SEED, "steps"))
    before, after, step_losses = [], [], []
    for _ in range(STEPS):
        before.append(snapshot(model, state))
        state, metrics = step(state, store, gen)
        step_losses.append(float(metrics["loss"]))
        after.append(snapshot(model, state))
    return spec, before, after, step_losses


def reference_steps(doc, mix, spec, before) -> list:
    """The reference's ``train`` over each step's batch from the program's
    state before that step."""
    gen = torch.Generator().manual_seed(data.sub_seed(SEED, "steps"))
    window = ref.fragment_samples(doc)
    labels = data.labels(spec)
    outs = []
    for snap in before:
        ids, starts = ref.draw_step(gen, spec.utterances, data.lengths(spec, SEED), BATCH, window)
        x = ref.preprocess(data.raw_windows(spec, SEED, ids, starts, window, "cpu"), doc)
        outs.append(ref.train({**snap["params"], **snap["buffers"]}, [(x, labels[ids])], doc,
                              mix["recipe"], start={"m": snap["m"], "v": snap["v"],
                                                    "step": snap["step"]}))
    return outs


def step_gaps(before, after, step_losses, outs, recipe) -> list:
    """Per step: the loss, the clipped gradient, the running statistics
    (each against the reference's step), and the parameters' change against
    the reference's Adam step on the program's clipped gradient."""
    gaps = []
    for b, a, loss, out in zip(before, after, step_losses, outs):
        m, v = dict(b["m"]), dict(b["v"])
        for n, g in a["grad"].items():
            m.setdefault(n, torch.zeros_like(g))
            v.setdefault(n, torch.zeros_like(g))
        stepped = ref.adam_update(b["params"], a["grad"], m, v, b["step"] + 1, recipe)
        change_p = {n: a["params"][n] - b["params"][n] for n in stepped}
        change_r = {n: stepped[n] - b["params"][n] for n in stepped}
        run = max(float(((a["buffers"][n] - r).abs() / r.abs().clamp(min=1e-6)).max())
                  for n, r in out["running"].items())
        gaps.append({"loss": abs(loss - out["losses"][0]) / abs(out["losses"][0]),
                     "grad": worst_gap(a["grad"], out["grad1"]),
                     "change": worst_gap(change_p, change_r),
                     "running": run})
    return gaps


@pytest.fixture(scope="module")
def trained():
    doc, mix = small_config(), traffic()
    spec, before, after, step_losses = run_steps(doc, mix)
    return doc, mix, spec, before, after, step_losses, reference_steps(doc, mix, spec, before)


def test_three_steps_against_the_reference(trained):
    *_, before, after, step_losses, outs = trained
    gaps = step_gaps(before, after, step_losses, outs, trained[1]["recipe"])
    assert all(v < TOL for g in gaps for v in g.values()), gaps
    assert [s["step"] for s in after] == [1, 2, 3]
    assert all(np.isfinite(step_losses))


def test_the_first_step_moves_every_trained_leaf(trained):
    """The comparison is not vacuous: every leaf but ASP's conv bias (whose
    gradient is nought: a bias on the logits of a softmax over time) has a
    gradient and moves."""
    *_, before, after, _, outs = trained
    moving = ref.moving_leaves(outs[0]["grad1"])
    assert set(outs[0]["grad1"]) - moving == {"asp.conv.bias"}
    assert all(float((after[0]["params"][n] - before[0]["params"][n]).norm()) > 0
               for n in moving)


@pytest.mark.parametrize("control", controls_ecapa_train.CONTROLS)
def test_each_control_fails_the_comparison(trained, control):
    doc, mix, spec, *_ = trained
    undo = controls_ecapa_train.plant(control)
    try:
        _, before, after, step_losses = run_steps(doc, mix)
    finally:
        undo()
    gaps = step_gaps(before[:1], after[:1], step_losses[:1],
                     reference_steps(doc, mix, spec, before[:1]), mix["recipe"])[0]
    assert max(gaps.values()) > 10 * TOL, gaps


def plain_stats(h, x):
    """The plain versions' formula written out of place (autograd cannot
    run through their in-place products), here in float64."""
    w = torch.softmax(x, dim=1) if x is not None else 1.0 / h.shape[1]
    mean = (w * h).sum(dim=1)
    square = (w * h * h).sum(dim=1)
    return mean, (square - mean * mean).clamp(min=cuda_asp.STAT_EPS).sqrt()


@pytest.mark.parametrize("mode", ["weighted", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_asp_backward_against_autograd(mode, dtype):
    g = torch.Generator().manual_seed(3)
    h = (torch.randn(3, 37, 24, generator=g) * 2.0 + 0.5).to(dtype)
    x = (torch.rand(3, 37, 24, generator=g) * 40.0 - 20.0).to(dtype)
    h[1, :, :8] = 0.75  # constant over time: std at its floor, no gradient through it
    gm, gs = torch.randn(3, 24, generator=g), torch.randn(3, 24, generator=g)
    hp, xp = h.clone().requires_grad_(), x.clone().requires_grad_()
    hr, xr = h.double().requires_grad_(), x.double().requires_grad_()
    counts = cuda_asp.asp_stats.backward_launches
    if mode == "weighted":
        got = torch.autograd.grad(cuda_asp.asp_stats(hp, xp), [hp, xp], torch.cat([gm, gs], 1))
        want = torch.autograd.grad(plain_stats(hr, xr), [hr, xr], (gm.double(), gs.double()))
    else:
        got = torch.autograd.grad(cuda_asp.asp_stats(hp), [hp], (gm, gs))
        want = torch.autograd.grad(plain_stats(hr, None), [hr], (gm.double(), gs.double()))
    assert cuda_asp.asp_stats.backward_launches == counts  # the CPU path counts none
    # f32: the softmax over logits spread over ±20 and the statistics carry
    # f32 rounding into every element, and dlogits sums terms that cancel
    # over time (readings 8e-8–3.4e-5); bf16 rounds each element to 2^-9
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == h.shape
        err = (a.double() - b.double()).norm() / b.double().norm()
        assert err < tol, err


def aam_speechbrain(outputs, targets, margin, scale):
    """SpeechBrain's ``AdditiveAngularMargin.forward`` (easy_margin False),
    then ``LogSoftmaxWrapper``'s KL divergence to one-hot targets, summed
    and divided by the number of targets."""
    cos_m, sin_m = math.cos(margin), math.sin(margin)
    th, mm = math.cos(math.pi - margin), math.sin(math.pi - margin) * margin
    cosine = torch.clamp(outputs.float(), -1 + 1e-7, 1 - 1e-7)
    sine = torch.sqrt(1.0 - torch.pow(cosine, 2))
    phi = cosine * cos_m - sine * sin_m
    phi = torch.where(cosine > th, phi, cosine - mm)
    onehot = F.one_hot(targets, outputs.shape[1]).float()
    logits = scale * (onehot * phi + (1.0 - onehot) * cosine)
    kl = F.kl_div(F.log_softmax(logits, dim=1), onehot, reduction="sum")
    return kl / onehot.sum()


def test_aam_against_speechbrains_formula():
    g = torch.Generator().manual_seed(5)
    cosine = torch.rand(64, 40, generator=g) * 2.0 - 1.0
    labels = torch.randint(0, 40, (64,), generator=g)
    cosine[:8, :] = -0.995  # every target at cos ≤ cos(π − m): the other branch
    cosine[8:10] = 1.0  # the clamp
    assert bool((cosine[torch.arange(64), labels] <= math.cos(math.pi - 0.2)).sum() >= 8)
    got = losses.aam_softmax(cosine, labels, 0.2, 30.0)
    want = aam_speechbrain(cosine, labels, 0.2, 30.0)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    # the reference's transcription too
    assert abs(float(ref.aam_loss(cosine, labels, 0.2, 30.0)) - float(want)) <= 1e-5 * float(want)


def test_the_training_spans(trained):
    doc, mix, *_ = trained
    cfg, spec, model, state, step, store = build(doc, mix)
    gen = torch.Generator().manual_seed(1)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, store, gen)
    records = profiling.spans()
    profiling.clear_spans()
    names = [r.name for r in records]
    stages = ["ecapa.frontend", "ecapa.layer1", "ecapa.block.1", "ecapa.block.2",
              "ecapa.block.3", "ecapa.mfa", "ecapa.asp", "ecapa.head", "ecapa.aam"]
    assert names[:3] == ["train_step", "fetch_batch", "forward"]
    assert [n for n in names if n in stages] == stages
    assert names.count("ecapa.asp_bwd") == names.count("ecapa.asp_bwd.global") == 1
    assert all(r.rows == BATCH for r in records)
    by = {r.name: r for r in records}
    assert by["ecapa.asp_bwd"].parent == by["ecapa.asp_bwd.global"].parent == "backward"
    assert "embed" not in names  # the training forward is not the inference one


def test_fit_trains_ecapa(tmp_path):
    """``fit(mode="ecapa_tdnn")`` on a tiny config: the loss falls, the
    records carry the n-shot accuracy, the optimizer has the recipe's weight
    decay."""
    cfg = C.ecapa_tdnn(
        ecapa=C.EcapaConfig(channels=(32, 32, 32, 32, 96), se_channels=8, attention_channels=8,
                            embedding_dim=16, compute_dtype="float32"),
        mel=C.MelConfig(n_fft=400, hop_length=160, win_length=400, n_mels=24, fmax=8000.0),
        data=C.DataConfig(seconds=0.4, downsampling=1, whiten_rms=None),
        train=C.TrainConfig(batch_size=16, num_steps=12, evaluate_every=6, num_eval_tasks=40,
                            learning_rate=1e-3, clipnorm=5.0, log_path=str(tmp_path / "m.jsonl")))
    store = synthetic_store(4, n_speakers=5, utterances_per_speaker=4, min_seconds=0.5,
                            max_seconds=0.7)
    step_losses = []
    with pytest.warns(UserWarning, match="TRAINING store"):
        state, history = fit(cfg, store, device="cpu", verbose=False,
                             on_step=lambda i, m: step_losses.append(float(m["loss"])))
    assert state.step == 12 and [r["step"] for r in history] == [6, 12]
    assert all(0.0 <= r["val_1-shot_acc"] <= 1.0 for r in history)
    assert state.optimizer.adam.defaults["weight_decay"] == cfg.weight_decay == 2e-6
    assert np.isfinite(step_losses).all()
    assert np.mean(step_losses[-3:]) < np.mean(step_losses[:3])


def test_fit_refuses_what_ecapa_does_not_train_on():
    with pytest.raises(NotImplementedError, match="ECAPA-TDNN trains on a device store"):
        from voicemap_tpu_torch.train.loop import _make_step

        _make_step(None, C.ecapa_tdnn(), streaming=True, dp=False)


def test_the_preset_has_the_recipes_training_values():
    cfg = C.ecapa_tdnn()
    assert (cfg.aam_margin, cfg.aam_scale, cfg.weight_decay) == (0.2, 30.0, 2e-6)
    assert (cfg.train.batch_size, cfg.train.learning_rate, cfg.train.clipnorm) == (32, 1e-3, 5.0)
    # the benchmark cell's recipe is the preset's, its batch apart
    mix = json.loads((REPO / "portbench/traffic/train_aam_b512.json").read_text())
    doc = json.loads((REPO / "portbench/configs/ecapa_tdnn_train.json").read_text())
    got = train_ecapa.train_config(doc, mix)
    assert got.replace(train=cfg.train) == cfg and got.train.batch_size == 512
    assert ref_model.tdnns(doc)[-1][0] == "asp.tdnn"
