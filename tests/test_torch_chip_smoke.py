"""chip_smoke.py's phases rehearsed on the CPU at a tiny size.

The script routes every tensor through ``chip_smoke.DEVICE``; here that is the
CPU, the kernels' plain versions stand in for the kernels (and count as their
launches), the build and the CUDA-event timers are stubbed, and the sizes
and the configs are cut down (filters 32, 0.128 s fragments, train batches
of 8, 12 train steps, B8 and B3 at (100, 32 → 64), (50, 64 → 96) and
(25, 96 → 128), and at their edge shapes as the card runs them; config #4 at 0.15 s, 16 frames, 32 mels; config #2 at
the same 0.128 s and filters 32, 8 pairs a train step, 40 verification
pairs, B9 timed at (1, 40, 36, 16) and (50, 1, 5, 16); config #5's store
12 × 7 utterances of 0.2–0.3 s, the process groups of pod_slice and
dp_slice on gloo); the train
policies resolve as they do on the card (B4/B5 and the fused blocks-1+ op).
What this shows
is the control flow, the shapes and the records of every phase, the
``kernels`` line's keys and the last line; what the kernels compute on the
card only the script itself, run there, shows. The script runs once for the
module (``rehearsal``), and each test reads its records.
"""

import contextlib
import dataclasses
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from voicemap_tpu_torch.config import (
    DataConfig, EcapaConfig, EncoderConfig, ExperimentConfig, MelConfig, SiameseConfig,
    TrainConfig, dilated_4khz, ecapa_tdnn,
)
from voicemap_tpu_torch.ops import (
    block0_train_tc, cuda_asp, cuda_conv, cuda_conv_train, cuda_distance, cuda_melspec,
    cuda_preprocess, cuda_quant_block, cuda_routing, cuda_wgrad,
)
from voicemap_tpu_torch.parallel import dryrun
from voicemap_tpu_torch.train import steps

KERNEL_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms"}


def count_plain_versions(monkeypatch):
    """The plain versions count as launches where the wrappers call them, on
    the counter of the kernel the card would launch: B2's, B4's and B5's
    f32-GEMM kernels for a float32 GEMM, B6's DFT route for an n_fft it
    takes."""
    block0_ref, mel_ref = cuda_conv.conv_block0_reference, cuda_melspec.log_mel_reference

    def block0_counted(*a, **k):
        gemm = a[10] if len(a) > 10 else k.get("gemm_dtype", torch.bfloat16)
        if gemm == torch.float32:
            cuda_conv.conv_block0.f32_launches += 1
        else:
            cuda_conv.conv_block0.launches += 1
        return block0_ref(*a, **k)

    def mel_counted(x, cfg, sr):
        cuda_melspec.log_mel.launches += 1
        if cuda_melspec.log_mel_route(cfg, sr) == "dft":
            cuda_melspec.log_mel.dft_launches += 1
        return mel_ref(x, cfg, sr)

    train_ref = cuda_conv_train.conv_block0_train_reference
    train_bwd_ref = cuda_conv_train.conv_block0_train_bwd_reference

    def train_counted(*a, **k):  # B4: the f32 route for a float32 GEMM
        gemm = a[5] if len(a) > 5 else k.get("gemm_dtype", torch.bfloat16)
        wrapper = cuda_conv_train.conv_block0_train
        if gemm == torch.float32:
            wrapper.f32_launches += 1
        else:
            wrapper.launches += 1
        return train_ref(*a, **k)

    def train_bwd_counted(*a, **k):  # B5, likewise
        gemm = a[9] if len(a) > 9 else k.get("gemm_dtype", torch.bfloat16)
        wrapper = cuda_conv_train.conv_block0_train_bwd
        if gemm == torch.float32:
            wrapper.f32_launches += 1
        else:
            wrapper.launches += 1
        return train_bwd_ref(*a, **k)

    monkeypatch.setattr(cuda_conv, "conv_block0_reference", block0_counted)
    monkeypatch.setattr(cuda_melspec, "log_mel_reference", mel_counted)
    monkeypatch.setattr(cuda_conv_train, "conv_block0_train_reference", train_counted)
    monkeypatch.setattr(cuda_conv_train, "conv_block0_train_bwd_reference", train_bwd_counted)
    pool_ref, route_ref = cuda_routing.pool_fwd_reference, cuda_routing.route_bwd_reference

    def pool_counted(*a, **k):  # B7: the index mode on its own counter
        idx_mode = a[5] if len(a) > 5 else k.get("want_idx", False)
        if idx_mode:
            cuda_routing.pool_fwd.idx_launches += 1
        else:
            cuda_routing.pool_fwd.launches += 1
        return pool_ref(*a, **k)

    def route_counted(z, b, sel, *a, **k):
        if sel.dtype == torch.int8:
            cuda_routing.route_bwd.idx_launches += 1
        else:
            cuda_routing.route_bwd.launches += 1
        return route_ref(z, b, sel, *a, **k)

    monkeypatch.setattr(cuda_routing, "pool_fwd_reference", pool_counted)
    monkeypatch.setattr(cuda_routing, "route_bwd_reference", route_counted)
    for ref, counter in (("attentive_stats_reference", "launches"),
                         ("global_stats_reference", "global_launches")):  # ASP's two modes
        def asp_counted(*a, _ref=getattr(cuda_asp, ref), _counter=counter, **k):
            setattr(cuda_asp.asp_stats, _counter, getattr(cuda_asp.asp_stats, _counter) + 1)
            return _ref(*a, **k)
        monkeypatch.setattr(cuda_asp, ref, asp_counted)
    asp_bwd_ref = cuda_asp.stats_backward_reference

    def asp_bwd_counted(*a, **k):  # ASP's backward, either mode
        cuda_asp.asp_stats.backward_launches += 1
        return asp_bwd_ref(*a, **k)

    monkeypatch.setattr(cuda_asp, "stats_backward_reference", asp_bwd_counted)
    for mod, ref, wrapper in ((cuda_conv, "conv_blockn_reference", cuda_conv.conv_blockn),
                              (cuda_conv, "conv_blockn_rows_reference", cuda_conv.conv_blockn),
                              (cuda_quant_block, "quant_block_train_reference",
                               cuda_quant_block.quant_block_train),
                              (cuda_quant_block, "quant_block_stage_reference",
                               cuda_quant_block.quant_block_stage),
                              (cuda_preprocess, "gather_whiten_reference",
                               cuda_preprocess.gather_whiten),
                              (cuda_quant_block, "quant_block_reference",
                               cuda_quant_block.quant_block),
                              (cuda_distance, "weighted_l1_reference",
                               cuda_distance.weighted_l1),
                              (cuda_routing, "bn_apply_reference", cuda_routing.bn_apply),
                              (cuda_routing, "bn_grad_reference", cuda_routing.bn_grad),
                              (cuda_wgrad, "conv_wgrad_reference", cuda_wgrad.conv_wgrad)):
        def counted(*a, _ref=getattr(mod, ref), _w=wrapper, **k):
            _w.launches += 1
            return _ref(*a, **k)
        monkeypatch.setattr(mod, ref, counted)


def _mesh_child_setup():
    """What each rank of mesh_slice calls first here: the plain versions
    counted as launches (a spawned rank sees none of this module's patches)."""
    count_plain_versions(pytest.MonkeyPatch())


def on_the_cpu(monkeypatch):
    """chip_smoke's constants, configs, kernels, timers and CUDA calls set
    for a run on the CPU (see the module's docstring)."""
    small = ExperimentConfig(data=DataConfig(seconds=0.128, downsampling=4),
                             encoder=EncoderConfig(filters=32, embedding_dim=16))
    small_dilated = ExperimentConfig(
        name="dilated_4khz", data=DataConfig(seconds=0.128, downsampling=4),
        encoder=dataclasses.replace(dilated_4khz().encoder, filters=32, embedding_dim=16))
    small_mel = ExperimentConfig(name="melspec_2d", mode="melspec2d",
                                 data=DataConfig(seconds=0.15, downsampling=1),
                                 encoder=EncoderConfig(filters=32, embedding_dim=16),
                                 mel=MelConfig(hop_length=128, win_length=384, n_mels=32),
                                 # 12 steps at this width learn at 3e-3, not at 1e-3
                                 train=TrainConfig(learning_rate=3e-3))
    small_siamese = ExperimentConfig(name="siamese_verification", mode="siamese",
                                     data=DataConfig(seconds=0.128, downsampling=4),
                                     encoder=EncoderConfig(filters=32, embedding_dim=16,
                                                           dropout=0.0),
                                     siamese=SiameseConfig(distance_metric="weighted_l1"),
                                     train=TrainConfig(batch_size=64, loss="bce"))
    small_ecapa = ecapa_tdnn().replace(
        data=DataConfig(seconds=0.5, downsampling=1, whiten_rms=None),
        mel=MelConfig(n_fft=400, hop_length=160, win_length=400, n_mels=40, fmin=0.0,
                      fmax=8000.0),
        ecapa=EcapaConfig(channels=(256, 256, 256, 256, 768), se_channels=32,
                          attention_channels=32, embedding_dim=48))
    for name, value in (("DEVICE", "cpu"), ("BATCH", 512), ("STORE_T", 2600), ("FRAG", 400),
                        ("CHECK_ROWS", 64), ("SWEEP", (1, 8, 512)),
                        ("QBLOCKS", ((100, 32, 64, False), (50, 64, 96, False),
                                     (25, 96, 128, True))),
                        ("classifier_baseline", lambda: small),
                        ("dilated_4khz", lambda: small_dilated),
                        ("DILATED_BLOCKS", ((100, 32, 32, 1, 2, False), (100, 32, 64, 2, 1, False),
                                            (50, 64, 64, 1, 4, False), (25, 96, 96, 1, 16, True))),
                        ("melspec_2d", lambda: small_mel), ("MEL_FRAG", 2400),
                        ("MEL_EDGES", ((1, 2400, dict(n_mels=16)), (5, 2399, {}),
                                       (5, 2400, dict(hop_length=160, win_length=400)),
                                       (2, 384, {}), (2, 1501, {}),
                                       (4, 2400, dict(n_fft=256, win_length=256,
                                                      hop_length=128)),
                                       (2, 2400, dict(n_fft=1024, win_length=1024,
                                                      hop_length=256)),
                                       (3, 2400, dict(n_fft=400, win_length=400,
                                                      hop_length=160)),
                                       (3, 2400, dict(n_fft=400, win_length=320,
                                                      hop_length=100)),
                                       (2, 2400, dict(n_fft=255, win_length=200)),
                                       (1, 2400, dict(n_fft=400, win_length=400,
                                                      hop_length=160)),
                                       (5, 1501, dict(n_fft=400, win_length=400,
                                                      hop_length=160)))),
                        ("B2_WIDE", (300, 64, 16)),
                        ("TRAIN_BATCH", 8), ("TRAIN_C0", 16), ("TRAIN_STEPS", 12),
                        ("TRAIN_BLOCKS", ((64, 100), (96, 50), (128, 24))),
                        ("TRAIN_TIMING_BATCHES", (4, 8)), ("B45_F32_WIDE", (2, 1200, 16)),
                        ("QTRAIN_EDGES", ((1, 100, 32, 64, 1, torch.bfloat16),
                                          (2, 101, 32, 64, 1, torch.bfloat16),
                                          (3, 30, 32, 72, 1, torch.bfloat16),
                                          (2, 31, 64, 100, 2, torch.float32),
                                          (3, 53, 32, 75, 4, torch.bfloat16),
                                          (2, 20, 64, 72, 16, torch.float32))),
                        ("RAW_STEPS", 4),
                        ("ecapa_tdnn", lambda: small_ecapa), ("ASP_SHAPE", (150, 37, 24)),
                        ("ASP_EMBED_ROWS", 2), ("ECAPA_TRAIN_BATCH", 6),
                        ("siamese_config", lambda: small_siamese),
                        ("B9_TIMING", (1, 40, 36, 16)), ("B9_NSHOT", (50, 1, 5, 16)),
                        ("SIAMESE_PAIRS", 40), ("SIAMESE_BATCH", 8),
                        ("MEL_TRAIN_BATCH", 16), ("MEL_TRAIN_TIMING_BATCHES", (4, 16)),
                        ("CORPUS_SPEC", dict(n_speakers=6, utterances_per_speaker=3,
                                             min_seconds=0.2, max_seconds=0.3,
                                             container="flac", seed=1234)),
                        ("CORPUS_SIAMESE_STEPS", 3),
                        ("PROTOCOL_TRAIN_SPEC", dict(n_speakers=6, utterances_per_speaker=4,
                                                     min_seconds=3.1, max_seconds=3.3,
                                                     container="wav", seed=1234)),
                        ("PROTOCOL_EVAL_SPEC", dict(n_speakers=12, utterances_per_speaker=7,
                                                    min_seconds=3.1, max_seconds=3.3,
                                                    container="wav", seed=4321)),
                        ("SOAK_STEPS", (4, 6)), ("SOAK_EVERY", 2), ("SIAMESE_CLI_STEPS", 3),
                        ("CLI_WIDTH", ("--filters", "32", "--embedding-dim", "16")),
                        ("SWEEP_PAIRS", 40),
                        ("POD_STORE", dict(n_speakers=12, utterances_per_speaker=7,
                                           min_seconds=0.2, max_seconds=0.3)),
                        ("POD_SCORER_TASKS", (498, 2000)), ("PG_BACKEND", "gloo"),
                        ("DP_TIMING_STEPS", 2), ("DP_FIT_STEPS", 3),
                        ("MESH_WORLD", 4), ("MESH_DATA_SEQ", {"data": 2, "seq": 2}),
                        ("MESH_DATA_MODEL", {"data": 2, "model": 2}), ("MESH_SP_BATCH", 2),
                        ("MESH_TP_ROWS", 2), ("MESH_MLP", (4, 16, 32, 8)),
                        ("MESH_PP", (16, 4, 4)), ("MESH_PPR_EVAL", (2, 2)),
                        ("MESH_PPR_TRAIN", (2, 2)), ("MESH_CALLS", 1),
                        ("MESH_STORE", dict(n_speakers=6, utterances_per_speaker=4,
                                            min_seconds=0.2, max_seconds=0.3)),
                        ("MESH_CHILD_SETUP", _mesh_child_setup),
                        # config #3 at 0.256 s: its last blocks' 16-sample halo fits the
                        # 16-sample shards of seq 2
                        ("mesh_configs", lambda: (small_dilated.replace(data=DataConfig(
                            seconds=0.256, downsampling=4)), small)),
                        ("card_line", lambda: "CPU rehearsal, 0 W")):
        monkeypatch.setattr(cs, name, value)
    # The policies as they resolve on the card: B4/B5, and the fused
    # blocks-1+ op unless the config says otherwise (its int8 forward for
    # quant_forward="int8", over every flag).
    monkeypatch.setattr(steps, "resolve_fused_block0", lambda cfg, model: True)
    monkeypatch.setattr(steps, "resolve_blockn", lambda cfg, device: (
        "fused_int8" if cfg.train.quant_forward == "int8" else
        "jnp" if cfg.train.use_fused_blockn is False else "fused"))
    count_plain_versions(monkeypatch)
    gather = cs.gather_whiten

    def gather_nan(store, idx, off, frag, *a, **k):  # the kernel's NaN rows for bad ids
        bad = (idx < 0) | (idx >= store.shape[0])
        out = gather(store, idx.clamp(0, store.shape[0] - 1), off, frag, *a, **k)
        out[bad] = float("nan")
        return out

    def fake_time(fn, *a, iters=30, warmup=5, queued=False, **k):
        fn(*a, **k)
        return {"mean_s": 1e-3, "p50_s": 1e-3, "p95_s": 1e-3, "min_s": 1e-3}

    def fake_tput(fn, *a, items_per_call, iters=30, warmup=5, **k):
        fn(*a, **k)
        return {"items_per_sec": items_per_call / 1e-3, "sec_per_call": 1e-3}

    def fake_profile(stages, batches=3):  # torch.profiler traces the card only there
        cs.stage_profile.run(stages)
        return {"window_ms_per_batch": 1.0, "idle_share": 0.0, "device_events_per_batch": 1.0,
                "layout_conversion_ms_per_batch": 0.0, "layout_conversion_kernels": {},
                "device_ms_by_op_per_batch": {}}

    monkeypatch.setattr(cs, "gather_whiten", gather_nan)
    monkeypatch.setattr(cs, "time_fn", fake_time)
    monkeypatch.setattr(cs.stage_profile, "profile", fake_profile)
    monkeypatch.setattr(cs, "throughput", fake_tput)
    monkeypatch.setattr(cs, "single_request_latency", lambda fn, *a, samples=20, warmup=3, **k: (
        fn(*a, **k), {"p50_s": 1e-3, "p95_s": 1e-3, "min_s": 1e-3, "mean_s": 1e-3,
                      "device_p50_s": 1e-3, "device_p95_s": 1e-3, "device_min_s": 1e-3,
                      "device_mean_s": 1e-3})[1])
    monkeypatch.setattr(cs._build, "build", lambda: (Path("none.so"), 0.0, ""))
    monkeypatch.setattr(cs._build, "library", lambda: None)
    for name, value in (("is_available", lambda: True), ("synchronize", lambda *a: None),
                        ("get_device_name", lambda *a: "cpu"), ("device_count", lambda: 1),
                        ("max_memory_allocated", lambda *a: 0),
                        ("reset_peak_memory_stats", lambda *a: None),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)


@pytest.fixture(scope="module")
def rehearsal():
    """One ``chip_smoke.main([])`` on the CPU → ``(exit code, stdout lines,
    JSON records)``; every test below reads it, under the same patches (the
    cut constants), which are undone after the module's last test."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        on_the_cpu(mp)
        with contextlib.redirect_stdout(buf):
            code = cs.main([])
        lines = buf.getvalue().strip().splitlines()
        yield code, lines, [json.loads(line) for line in lines if line.startswith("{")]


def test_every_phase_runs_on_the_cpu_at_a_tiny_size(rehearsal):
    code, lines, records = rehearsal
    assert code == 0
    assert lines[0] == lines[-3] == "CPU rehearsal, 0 W"
    phases = [r["phase"] for r in records if "phase" in r]
    assert phases == ["device", "build", "kernels", "train_kernels", "slice", "int8_slice",
                      "int8_fidelity_gate", "train_slice", "int8_train_slice",
                      "recompute_train_slice", "raw_store_slice", "timing", "attribution",
                      "train_layout", "train_timing",
                      "dilated_slice", "dilated_int8_slice", "dilated_int8_fidelity",
                      "dilated_train_slice", "dilated_timing", "wgrad_kernels",
                      "mel_kernels", "mel_bf16_slice", "mel_int8_slice", "mel_int8_fidelity",
                      "mel_timing", "asp_kernels", "ecapa_train", "siamese_kernels",
                      "siamese_bf16_slice",
                      "siamese_int8_slice", "verification", "score_support",
                      "siamese_train_slice", "siamese_timing", "mel_train_slice",
                      "mel_train_timing", "corpus_slice", "streaming_embed", "protocol_slice",
                      "pod_slice", "dp_slice", "mesh_slice", "total"]
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    nothing = {name: 0 for name in cs.KERNELS}
    # bf16: B1 and B2 once an embed chunk, B8 three times (blocks 1-3)
    assert by_phase["slice"]["launches"] == {**nothing, "gather_whiten": 2, "conv_block0": 2,
                                             "conv_blockn": 6}
    assert by_phase["int8_slice"]["launches"] == {**nothing, "gather_whiten": 2,
                                                  "conv_block0": 2, "quant_block": 6}
    checks = by_phase["kernels"]["checks"]
    b8 = [c for c in checks if c["kernel"] == "conv_blockn"]
    assert [c["shape"] for c in b8] == (
        [[64, 100, 32, 64, 3], [64, 50, 64, 96, 3], [64, 25, 96, 128, 3],
         [1, 100, 32, 64, 3], [1, 50, 64, 96, 3], [1, 25, 96, 128, 3]]
        + [list(e) for e in cs.B8_EDGES] + [[3, 300, 128, 256, 3]])
    assert all(c["err_over_bound"] <= 1.0 and c["bf16_min_row_cosine"] >= cs.B8_BF16_MIN_COSINE
               for c in b8)
    assert [c["out"] for c in b8[6:9]] == [[3, 500, 256], [1, 1, 64], [2, 1, 72]]
    assert b8[-1]["row_scales"] == list(cs.ROW_SCALES)
    b3 = [c for c in checks if c["kernel"] == "quant_block"]
    assert [c["shape"] for c in b3[3:]] == [
        [3, 500, 40], [3, 500, 40], [3, 500, 40], [1, 1, 8], [2, 65, 72], [2, 65, 72],
        [2, 150, 100], [3, 256, 75], [1, 50, 64], [1, 25, 96], [1, 12, 128], [3, 150, 256]]
    assert all(c["max_abs_err"] == 0.0 for c in b3)
    b10 = [c for c in checks if c["kernel"] == "quant_block_stage"]
    assert [(c["stage"], c["dtype"]) for c in b10] == [
        ("mma", "int32"), ("pool", "int32"), ("full", "int8")] * 3
    assert all(c["max_abs_err"] == 0.0 for c in b10)
    train = by_phase["train_slice"]
    steps_run = 12
    # the BatchNorm epilogue pair once a fused block a step
    assert train["launches"] == {**nothing, "gather_whiten": steps_run,
                                 "conv_block0_train": steps_run,
                                 "conv_block0_train_bwd": steps_run,
                                 "pool_fwd": 3 * steps_run, "route_bwd": 3 * steps_run,
                                 "bn_apply": 4 * steps_run, "bn_grad": 4 * steps_run}
    # the evaluation embeds through the model's own forward: B1, no B2 or B8
    assert train["eval_launches"] == {**nothing, "gather_whiten": 2}
    assert train["loss_last5_mean"] < train["loss_first5_mean"]
    assert train["plain_step"]["min_grad_cosine"] >= cs.STEP_MIN_COSINE
    # the plain step's eager chain is what the card's step is held to run
    # none of
    step = train["epilogue_step"]
    assert (step["kernels"]["bn_apply"], step["kernels"]["bn_grad"]) == (4, 4)
    assert step["plain"]["chain_ops"] >= 4 * 4
    # the pair checked at the four pool-rate shapes at the train step's
    # batch and the large one, and timed there
    shapes = [[8, 100, 16], [8, 50, 64], [8, 25, 96], [8, 12, 128]]
    epilogue = [c for c in by_phase["train_kernels"]["checks"]
                if c["kernel"] in ("bn_apply", "bn_grad")]
    assert [(c["kernel"], c["shape"]) for c in epilogue] == [
        (k, sh) for sh in shapes for k in ("bn_apply", "bn_grad")] * 2
    assert all(c["max_abs_err"] == 0.0 and c["rate"] == cs.EPILOGUE_RATE for c in epilogue)
    assert all(c["sums_err_over_bound"] <= 1.0 for c in epilogue if c["kernel"] == "bn_grad")
    assert [[r["batch"], r["T'"], r["C"]] for r in by_phase["train_timing"][
        "bn_epilogue_blocks"]] == shapes * 2
    timing = by_phase["train_timing"]
    policies = ("jnp", "fused", "fused_recompute", "fused_int8")
    assert [(r["batch"], r["blockn"]) for r in timing["train_step_turns"]] == [
        (b, p) for b in (4, 8) for p in (*policies, *reversed(policies))]
    assert [(r["batch"], r["blockn"], len(r["turns_ms"])) for r in timing["train_step"]] == [
        (b, p, 2) for b in (4, 8) for p in policies]
    assert [(r["batch"], r["blockn"]) for r in timing["train_step_profiles"]] == [
        (b, p) for b in (4, 8) for p in policies]
    # B7 per block at the train step's batch (with its plain version) and at
    # the largest timing batch; the fused step's layout conversions apart
    routing = timing["routing_blocks"]
    assert [(r["batch"], r["C"]) for r in routing] == [
        (b, c) for b in (8, 8) for c, _ in cs.TRAIN_BLOCKS]
    assert all("route_bwd_plain_ms" in r for r in routing[:3])
    assert by_phase["train_layout"]["fused_step"]["layout_conversion_ms_per_batch"] == 0.0
    # B4/B5 on the tensor cores at the train step's shape and B45_EDGES: a_sel
    # in f32 within its order bound, in bf16 within it before its rounding,
    # the count and the routing flipping only within the bound, B5's
    # recomputed selection B4's bit for bit; the f32 route at its edge
    train_checks = by_phase["train_kernels"]["checks"]
    b45 = [c for c in train_checks if c.get("route") == "tensor cores"]
    sel32 = [c for c in b45 if c.get("dtype") == "float32"]
    assert [c["shape"] for c in sel32] == [[8, 100, 16]] + [
        [B, T // 4, c] for B, T, c, _ in cs.B45_EDGES]
    assert [c["rows"] for c in sel32][-2:] == ["scaled", "ties"]
    assert all(c["err_over_bound"] <= 1.0 for c in b45 if "err_over_bound" in c)
    assert all(c["min_row_cosine"] >= cs.B45_MIN_COSINE for c in b45 if "min_row_cosine" in c)
    stage = [c for c in b45 if c["kernel"] == "conv_block0_train_bwd_stage"]
    assert len(stage) == len(sel32) and all(c["route_flips"] >= 0 for c in stage)
    assert all(c["flips"] >= 0 for c in b45 if c.get("dtype") == "count")
    assert all(c["rel_err"] <= cs.TRAIN_REL_TOL for c in b45 if "rel_err" in c)
    # the f32 route (3xTF32) at its edge, more items than CTAs, scaled rows
    # and ties: the same rules at the 3xTF32 unit, dW and db on B5's own
    # routes and masks, B5's selection B4's bit for bit
    f32_route = [c for c in train_checks if c.get("route") == "float32 GEMM"]
    assert [c["kernel"] for c in f32_route] == (["conv_block0_train"] * 5 + [
        "conv_block0_train_bwd"] * 2 + ["conv_block0_train_bwd_stage"]) * 4
    assert [(c["B"], c["rows"]) for c in f32_route[::8]] == [
        (2, "plain"), (2, "plain"), (3, "scaled"), (2, "ties")]
    assert all(c["err_over_bound"] <= 1.0 for c in f32_route if "err_over_bound" in c)
    assert all(c["rel_err"] <= cs.TRAIN_REL_TOL for c in f32_route if "rel_err" in c)
    assert all(c["route_flips"] >= 0 and c["relu_flips"] >= 0 for c in f32_route[7::8])
    assert f32_route[0]["tolerance"].startswith(
        f"|err| <= u*(4*K*(S+|bias|) + 4*|ref|), u = {block0_train_tc.tf32x3_unit()}")
    launches = by_phase["train_kernels"]["launches"]
    # B4 twice a case (f32 and bf16 a_sel); B5 once, and here its stage
    # entry's plain version counts once more
    assert launches["conv_block0_train_f32"] == launches["conv_block0_train_bwd_f32"] == 8
    # B5 at the train step's own inputs, against the plain dW and db on its
    # own routes and relu masks, the flips counted
    step = [c for c in train_checks if c.get("case") == "b5_step"]
    assert [(c["seed"], c["upstream"]) for c in step] == [(cs.B5_STEP_SEED, "plain"),
                                                          (cs.B5_STEP_SEED, "kernels")]
    for c in step:
        assert c["shape"][0] == 8 and c["route_flips"] >= 0 and c["relu_flips"] >= 0
        assert [ch["rel_err"] <= cs.TRAIN_REL_TOL for ch in c["checks"]] == [True, True]
    # B4 and B5 timed at both batches, both routes, queued and back to back
    rows45 = by_phase["train_timing"]["block0_batches"]
    assert [r["batch"] for r in rows45] == [4, 8]
    for r in rows45:
        for name in ("conv_block0_train", "conv_block0_train_bwd", "conv_block0_train_f32",
                     "conv_block0_train_bwd_f32"):
            assert {f"{name}_ms", f"{name}_back_to_back_ms", f"{name}_bound_share"} <= set(r)
            assert r["bound"][name]["bound_by"] in ("bytes", "operations")
    b7 = [c for c in by_phase["train_kernels"]["checks"] if c["kernel"] == "route_bwd"][::2]
    assert [(c["B"], c["pool"], c["rows"]) for c in b7[3:]] == [
        (e[0], e[3], e[5]) for e in cs.ROUTING_EDGES]
    assert all(c["max_abs_err"] == 0.0 for c in b7)
    assert by_phase["int8_fidelity_gate"]["pass"]
    # config #4: B1 and B6 once for each of the two embed chunks, in each path
    for path in ("mel_bf16", "mel_int8"):
        assert by_phase[f"{path}_slice"]["launches"] == {**nothing, "gather_whiten": 2,
                                                         "log_mel": 2}
        assert by_phase[f"{path}_slice"]["min_cosine_vs_plain"] >= cs.TABLE_MIN_COSINE
    assert by_phase["mel_int8_fidelity"]["pass"]
    mel_checks = by_phase["mel_kernels"]["checks"]
    assert [c["shape"] for c in mel_checks] == [[512, 2400], [64, 2400], [1, 2400], [5, 2399],
                                                [5, 2400], [2, 384], [2, 1501], [4, 2400],
                                                [2, 2400], [3, 2400], [3, 2400], [2, 2400],
                                                [1, 2400], [5, 1501], [4, 2400], [4, 2400]]
    assert all(c["max_abs_err"] <= cs.B6_ATOL for c in mel_checks[1:])
    # n_fft 512, 256 and 1024 take the FFT kernel, n_fft 400 and 255 the DFT kernel
    assert [(c["n_fft"], c["route"]) for c in mel_checks[1:]] == (
        [(512, "fft")] * 6 + [(256, "fft"), (1024, "fft"), (400, "dft"), (400, "dft"),
                              (255, "dft"), (400, "dft"), (400, "dft"), (512, "fft"),
                              (400, "dft")])
    assert [(c["win"], c["hop"]) for c in mel_checks[10:12]] == [(320, 100), (200, 128)]
    assert mel_checks[1]["max_abs_err_vs_rfft_route"] <= cs.B6_ATOL
    assert mel_checks[-1]["rows"][:2] == ["tone 440 Hz", "zeros"]
    assert by_phase["mel_kernels"]["launches"]["log_mel_dft"] == 6
    assert by_phase["mel_timing"]["log_mel_dft"]["route"] == "dft"
    assert by_phase["mel_timing"]["log_mel"]["route"] == "fft"
    # B2: the tensor-core kernel in f32, bf16 and int8 out and the f32-GEMM
    # kernel at the main shape, B = 1, T % 4 != 0 with C = 16 and 160, rows of
    # very different scale and more rows than a grid's y dimension held
    b2 = [c for c in checks if c["kernel"] == "conv_block0"]
    tc = [("tensor cores", dt) for dt in ("float32", "bfloat16", "int8")]
    f32 = [("float32 GEMM", "float32")]
    want_b2 = (([64, 100, 128], tc + f32), ([1, 100, 128], tc), ([3, 250, 16], tc + f32),
               ([2, 1024, 160], tc + f32), ([3, 100, 128], tc), ([300, 16, 16], tc))
    assert [(c["shape"], c["route"], c["dtype"]) for c in b2] == [
        (shape, route, dt) for shape, kinds in want_b2 for route, dt in kinds]
    assert all(c.get("err_over_bound", 0.0) <= 1.0 for c in b2)
    assert all(c["max_abs_err"] <= 1.0 for c in b2 if c["dtype"] == "int8")
    assert by_phase["kernels"]["launches"]["conv_block0_f32"] == 3
    mel_timing = by_phase["mel_timing"]
    # an rfft's operations at the f32 rate take less than moving the bytes
    assert mel_timing["log_mel"]["bound_by"] == "bytes"
    assert mel_timing["log_mel"]["dft_f32_ms"] > mel_timing["log_mel"]["dft_tf32_ms"] > 0
    assert mel_timing["log_mel_dft"]["dft_tf32x3_ms"] == pytest.approx(
        3 * mel_timing["log_mel_dft"]["dft_tf32_ms"], rel=0.05)
    assert set(mel_timing["paths"]) == {"bf16", "int8"}
    for path in ("bf16", "int8"):
        assert {"utt_per_s_b2048", "batch1_p50_ms_events", "peak_mem_gb"} <= set(
            mel_timing["paths"][path])
    assert [r["batch"] for r in by_phase["timing"]["int8_vs_bf16_sweep"]] == [1, 8, 512]
    # config #2: each n-shot run B1 and B2 once an embed chunk, B9 once (and
    # B3 three times a chunk in int8); verification and score_support B9 once
    assert by_phase["siamese_bf16_slice"]["launches"] == {
        **nothing, "gather_whiten": 2, "conv_block0": 2, "conv_blockn": 6, "weighted_l1": 1}
    assert by_phase["siamese_int8_slice"]["launches"] == {
        **nothing, "gather_whiten": 2, "conv_block0": 2, "quant_block": 6, "weighted_l1": 1}
    for phase in ("verification", "score_support"):
        assert by_phase[phase]["launches"] == {**nothing, "weighted_l1": 1}
        assert by_phase[phase]["b9_vs_plain"]["tolerance"] == "equal"
    assert 0.0 <= by_phase["verification"]["eer"] <= 1.0
    assert 0.0 <= by_phase["verification"]["auc"] <= 1.0
    assert by_phase["verification"]["num_pairs"] == 40
    assert by_phase["score_support"]["shape"] == [320, 320]
    b9_checks = by_phase["siamese_kernels"]["checks"]
    assert [c["shape"] + [c["D"]] for c in b9_checks] == [
        [1, 40, 36, 16], [50, 1, 5, 16], [1, 33, 41, 64], [1, 1, 1, 64], [3, 7, 130, 17],
        [1, 5, 7, cs.MAX_D], [4, 1, 3, cs.MAX_D]]
    assert all(c["max_abs_err"] == 0.0 for c in b9_checks)
    strain = by_phase["siamese_train_slice"]
    assert strain["launches"] == {**nothing, "gather_whiten": 2 * steps_run,
                                  "conv_block0_train": steps_run,
                                  "conv_block0_train_bwd": steps_run,
                                  "pool_fwd": 3 * steps_run, "route_bwd": 3 * steps_run,
                                  "bn_apply": 4 * steps_run, "bn_grad": 4 * steps_run}
    assert strain["eval_launches"] == {**nothing, "gather_whiten": 2, "weighted_l1": 1}
    assert strain["loss_last5_mean"] < strain["loss_first5_mean"]
    plain_steps = strain["plain_steps"]
    assert set(plain_steps) == {f"{loss}_{dt}" for loss in ("bce", "contrastive")
                                for dt in ("float32", "bfloat16")}
    for name, rec in plain_steps.items():
        assert rec["held"] == name.endswith("float32")
        assert rec["min_grad_cosine"] >= cs.STEP_MIN_COSINE
        # e1 − e2 cancels the last block's BatchNorm bias and the embedding bias
        assert set(rec["zero_grad"]) <= {"encoder.blocks.3.bn.bias", "encoder.embed.bias"}
    # the contrastive loss does not reach the head
    assert plain_steps["contrastive_float32"]["params_with_grad"] == \
        plain_steps["bce_float32"]["params_with_grad"] - 2
    stiming = by_phase["siamese_timing"]
    assert stiming["weighted_l1"]["timing"]["shape"] == [1, 40, 36, 16]
    assert stiming["weighted_l1"]["nshot"]["bound_by"] == "bytes"
    for form in ("timing", "nshot"):
        assert {"ms", "queued_ms", "host_us", "library_host_us", "plain_ms", "broadcast_ms",
                "library_ms", "bound_ms"} <= set(stiming["weighted_l1"][form])
        assert stiming["weighted_l1"][form]["host_us"] > 0
    assert stiming["train_step"]["rows"] == 16 and stiming["train_step"]["blockn"] == "fused"
    timing = by_phase["timing"]
    assert [(r["block"], r["T"], r["cin"], r["cout"]) for r in timing["conv_blockn"]] == [
        (1, 100, 32, 64), (2, 50, 64, 96), (3, 25, 96, 128)]
    assert all({"ms", "plain_ms", "bound_ms", "library_ms", "cudnn_block_ms"} <= set(r)
               for r in timing["conv_blockn"])
    assert list(timing["bf16_stage_ms"]) == ["conv_block0", "block_1", "block_2", "block_3",
                                             "global_max_dense"]
    assert [t["blocks"] for t in timing["b8_against_cudnn_blocks_turns"]] == [
        "b8", "cudnn", "cudnn", "b8"]
    attribution = by_phase["attribution"]
    assert [[st["stage"] for st in r["stages"]] for r in attribution["blocks"]] == [
        ["mma", "pool", "full"]] * 3
    assert [r["quant_block_out"] for r in attribution["blocks"]] == ["int8", "int8", "bfloat16"]
    assert attribution["launches"]["quant_block_stage"] > 0
    kernels = records[-2]["kernels"]
    assert [k["name"] for k in kernels] == ["gather_whiten", "conv_block0",
                                            "conv_block0_int8", "conv_block0_f32",
                                            "quant_block", "conv_block0_train",
                                            "conv_block0_train_bwd", "conv_block0_train_f32",
                                            "conv_block0_train_bwd_f32", "pool_fwd", "route_bwd",
                                            "log_mel", "log_mel_dft", "weighted_l1",
                                            "conv_blockn", "quant_block_stage",
                                            "quant_block_train", "pool_fwd_idx",
                                            "route_bwd_idx", "bn_apply", "bn_grad",
                                            "asp_stats", "asp_global", "asp_bwd",
                                            "conv_wgrad"]
    for k in kernels:
        assert KERNEL_KEYS <= set(k) and k["launches"] > 0 and k["bound_by"] in (
            "bytes", "operations")
    by_name = {k["name"]: k for k in kernels}
    assert by_name["pool_fwd"]["launches_by_path"] == {"train": 3 * steps_run,
                                                       "int8_train": 3 * steps_run,
                                                       "raw_train": 3 * 4,
                                                       "dilated_train": 7 * steps_run,
                                                       "siamese_train": 3 * steps_run,
                                                       "corpus_device": 3 * steps_run,
                                                       "corpus_streaming": 3 * steps_run,
                                                       "corpus_siamese": 9,
                                                       "cli_train": 3 * 6, "cli_siamese_train": 9,
                                                       "dp_train": 3 * steps_run,
                                                       "dp_fit": 3 * 3}
    for name in ("bn_apply", "bn_grad"):  # one a fused block on every train path
        assert by_name[name]["launches_by_path"] == {
            "train": 4 * steps_run, "int8_train": 4 * steps_run, "raw_train": 4 * 4,
            "dilated_train": 8 * steps_run, "siamese_train": 4 * steps_run,
            "corpus_device": 4 * steps_run, "corpus_streaming": 4 * steps_run,
            "corpus_siamese": 12, "cli_train": 4 * 6, "cli_siamese_train": 12,
            "dp_train": 4 * steps_run, "dp_fit": 4 * 3, "recompute_train": 4 * steps_run}
        assert by_name[name]["max_abs_err"] == 0.0  # the CPU runs the plain versions
        assert by_name[name]["source"] == "voicemap_tpu_torch/csrc/routing.cu"
    assert by_name["gather_whiten"]["launches_by_path"]["train"] == steps_run
    assert by_name["gather_whiten"]["launches_by_path"]["siamese_train"] == 2 * steps_run
    assert by_name["weighted_l1"]["launches_by_path"] == {
        "siamese_bf16": 1, "siamese_int8": 1, "verification": 1, "score_support": 1,
        "cli_siamese_train": 1, "cli_siamese_protocol": 6, "pod_siamese": 1}
    assert by_name["weighted_l1"]["launches"] == 12
    assert by_name["weighted_l1"]["max_abs_err"] == 0.0
    assert by_name["weighted_l1"]["library_ms"] is not None
    assert by_name["quant_block"]["launches_by_path"] == {
        "int8": 6, "dilated_int8": 14, "siamese_int8": 6, "streaming_int8": 3,
        "cli_protocol_int8": 6, "cli_int8_gate": 6, "cli_embed": 6, "pod_int8": 3 * 4}
    assert by_name["conv_blockn"]["launches_by_path"] == {"bf16": 6, "dilated_bf16": 14,
                                                          "siamese_bf16": 6, "streaming_bf16": 3,
                                                          "cli_sweep": 6,
                                                          "recompute_train": 3 * steps_run,
                                                          "tp_embed": 3 * 4,
                                                          "pp_real_eval": 3 * 2,
                                                          "sp_embed": 0, "pp_real_train": 0}
    assert by_name["conv_blockn"]["library_ms"] is not None
    assert by_name["conv_blockn"]["source"] == "voicemap_tpu_torch/csrc/conv_blockn.cu"
    assert list(by_name["quant_block_stage"]["launches_by_path"]) == ["attribution"]
    assert by_name["quant_block_stage"]["max_abs_err"] == 0.0
    assert by_name["conv_block0_train_bwd"]["library_ms"] is not None
    # B4's and B5's f32 route runs on no path: the train-kernels phase's count
    for name in ("conv_block0_train_f32", "conv_block0_train_bwd_f32"):
        assert by_name[name]["launches_by_path"] == {"train_kernels": 8}
    assert by_name["conv_block0_train_bwd_f32"]["library_ms"] is not None
    assert by_name["conv_block0_train"]["launches_by_path"] == {"train": steps_run,
                                                                "int8_train": steps_run,
                                                                "raw_train": 4,
                                                                "recompute_train": steps_run,
                                                                "dilated_train": steps_run,
                                                                "siamese_train": steps_run,
                                                                "corpus_device": steps_run,
                                                                "corpus_streaming": steps_run,
                                                                "corpus_siamese": 3,
                                                                "cli_train": 6,
                                                                "cli_siamese_train": 3,
                                                                "dp_train": steps_run,
                                                                "dp_fit": 3}
    assert by_name["log_mel"]["launches_by_path"] == {"mel_bf16": 2, "mel_int8": 2,
                                                      "mel_train": steps_run,
                                                      "streaming_mel": 1, "ecapa_train": 1}
    assert by_name["log_mel_dft"]["launches_by_path"] == {"mel_kernels": 6, "ecapa_train": 1}
    assert by_name["conv_block0_f32"]["launches_by_path"] == {"kernels": 3}
    assert by_name["conv_block0"]["library_ms"] is not None
    assert by_name["log_mel"]["library_ms"] is not None
    assert by_name["gather_whiten"]["launches_by_path"]["mel_int8"] == 2
    assert by_name["gather_whiten"]["launches_by_path"]["dilated_train"] == steps_run
    assert by_name["conv_block0_int8"]["launches_by_path"]["dilated_int8"] == 2
    assert records[-1] == {"ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}}


def test_the_config_3_phases_run_on_the_cpu(rehearsal):
    """Config #3 (``dilated_4khz``): B3 and B8 at its block shapes and
    DILATED_EDGES in the kernels phase, B7 at pool 1; the bf16 slice (B1, B2,
    B8 × 7), the int8 slice (B1, B2, B3 × 7), the fidelity line, the train
    slice (B7 7 + 7 and ``conv_wgrad`` 4 a step) with its held f32 step, and
    the timing."""
    code, _, records = rehearsal
    assert code == 0
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    nothing = {name: 0 for name in cs.KERNELS}
    assert by_phase["dilated_slice"]["config"] == "dilated_4khz"
    assert by_phase["dilated_slice"]["launches"] == {**nothing, "gather_whiten": 2,
                                                     "conv_block0": 2, "conv_blockn": 14}
    assert by_phase["dilated_slice"]["min_cosine_vs_plain"] >= cs.TABLE_MIN_COSINE
    assert by_phase["dilated_int8_slice"]["launches"] == {**nothing, "gather_whiten": 2,
                                                          "conv_block0": 2, "quant_block": 14}
    assert by_phase["dilated_int8_slice"]["min_cosine_vs_plain_int8_path"] >= \
        cs.TABLE_MIN_COSINE
    gate = by_phase["dilated_int8_fidelity"]
    assert gate["held"] is False and gate["int8_served"] == (gate["min_cosine"] >= cs.INT8_FIDELITY_GATE)
    assert gate["served_dtype"] == ("int8" if gate["int8_served"] else "bfloat16")
    assert by_phase["int8_fidelity_gate"]["held"] is True
    train = by_phase["dilated_train_slice"]
    steps_run = 12
    assert train["launches"] == {**nothing, "gather_whiten": steps_run,
                                 "conv_block0_train": steps_run,
                                 "conv_block0_train_bwd": steps_run,
                                 "pool_fwd": 7 * steps_run, "route_bwd": 7 * steps_run,
                                 "bn_apply": 8 * steps_run, "bn_grad": 8 * steps_run,
                                 "conv_wgrad": 4 * steps_run}
    assert train["eval_launches"] == {**nothing, "gather_whiten": 2}
    assert train["loss_last5_mean"] < train["loss_first5_mean"]
    assert train["plain_steps"]["float32"]["held"]
    assert not train["plain_steps"]["bfloat16"]["held"]
    assert train["plain_steps"]["float32"]["min_grad_cosine"] >= cs.STEP_MIN_COSINE
    dilated = by_phase["kernels"]["dilated_checks"]
    b3 = [c for c in dilated if c["kernel"] == "quant_block"]
    b8 = [c for c in dilated if c["kernel"] == "conv_blockn"]
    n_main = len(cs.DILATED_BLOCKS)
    n_all = 2 * n_main + len(cs.DILATED_EDGES) + 1
    assert len(b3) == len(b8) == n_all
    assert all(c["max_abs_err"] == 0.0 for c in b3)
    assert all(c["err_over_bound"] <= 1.0 and c["bf16_min_row_cosine"] >= cs.B8_BF16_MIN_COSINE
               for c in b8)
    assert [(c["pool"], c["dilation"]) for c in b3[:n_main]] == [
        (p, d) for _, _, _, p, d, _ in cs.DILATED_BLOCKS]
    assert [c["shape"] for c in b3[2 * n_main:-1]] == [
        [B, T // p, cout] for B, T, _, cout, p, _, _ in cs.DILATED_EDGES]
    assert [c["out"] for c in b8[2 * n_main:-1]] == [
        [B, T // p, cout] for B, T, _, cout, p, _, _ in cs.DILATED_EDGES]
    assert b3[-1]["row_divisors"] == [1, 64, 8] and b8[-1]["row_scales"] == list(cs.ROW_SCALES)
    b7 = [c for c in by_phase["train_kernels"]["checks"] if c["kernel"] == "route_bwd"][::2]
    assert [(c["B"], c["pool"]) for c in b7[-4:]] == [(32, 1)] * 4
    timing = by_phase["dilated_timing"]
    assert [(r["block"], r["pool"], r["dilation"]) for r in timing["conv_blockn"]] == [
        (i, p, d) for i, (p, d) in enumerate(zip((1, 2, 1, 2, 1, 2, 1),
                                                 (2, 1, 4, 1, 8, 1, 16)), start=1)]
    assert [(r["pool"], r["dilation"], r["out"]) for r in timing["quant_block"]] == [
        (p, d, "bfloat16" if d == 16 else "int8")
        for p, d in zip((1, 2, 1, 2, 1, 2, 1), (2, 1, 4, 1, 8, 1, 16))]
    for rows in (timing["conv_blockn"], timing["quant_block"]):
        assert all({"ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(r)
                   for r in rows)
    assert set(timing["paths"]) == {"bf16", "int8"}
    for path, first in (("bf16", "conv_block0"), ("int8", "conv_block0_int8")):
        rec = timing["paths"][path]
        assert {"utt_per_s_b2048", "batch1_p50_ms_events", "peak_mem_gb"} <= set(rec)
        assert list(rec["stage_ms"])[0] == first and len(rec["stage_ms"]) == 9
    assert [(r["batch"], r["blockn"]) for r in timing["train_step"]] == [
        (b, p) for b in (4, 8) for p in ("jnp", "fused")]
    assert [(r["batch"], r["block"]) for r in timing["cudnn_convs"]] == [
        (b, i) for b in (4, 8) for i in range(1, 8)]
    assert all({"nhwc_fwd_ms", "nhwc_bwd_ms", "nct_fwd_ms", "nct_bwd_ms",
                "nhwc_fwd_autotuned_ms", "nhwc_bwd_autotuned_ms"} <= set(r)
               for r in timing["cudnn_convs"])


def test_the_wgrad_phase_runs_on_the_cpu(rehearsal):
    """``conv_wgrad`` at config #3's four dilated blocks at the train
    slice's batch, CHECK_ROWS and BATCH rows (here the plain version against
    float64, launches counted), timed per block beside its bound and cuDNN's
    wgrad; its kernels-line entry: the check's launches, config #3's 4 a
    train step and none on config #1's."""
    code, _, records = rehearsal
    assert code == 0
    phase = {r["phase"]: r for r in records if "phase" in r}["wgrad_kernels"]
    nothing = {name: 0 for name in cs.KERNELS}
    assert [(c["block"], c["dilation"], c["shape"][0]) for c in phase["checks"]] == [
        (i, d, rows) for i, d in ((1, 2), (3, 4), (5, 8), (7, 16))
        for rows in (cs.TRAIN_BATCH, cs.CHECK_ROWS, cs.BATCH)]
    assert all(c["rel_err_of_max"] <= cs.TRAIN_REL_TOL and c["repeat_equal"]
               for c in phase["checks"])
    assert phase["launches"] == {**nothing, "conv_wgrad": 24}
    assert [r["shape"] for r in phase["timing"]] == [
        [cs.BATCH, 100, 32, 32], [cs.BATCH, 50, 64, 64], [cs.BATCH, 25, 96, 96],
        [cs.BATCH, 12, 128, 128]]
    assert all({"ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_share"}
               <= set(r) for r in phase["timing"])
    entry = {k["name"]: k for k in records[-2]["kernels"]}["conv_wgrad"]
    assert entry["launches_by_path"] == {"wgrad_kernels": 24, "dilated_train": 4 * 12,
                                         "train": 0}
    assert entry["source"] == "voicemap_tpu_torch/csrc/conv_wgrad.cu"
    assert entry["ms"] == pytest.approx(sum(r["ms"] for r in phase["timing"]))


def test_the_asp_phase_runs_on_the_cpu(rehearsal):
    """ASP's two modes checked at ASP_SHAPE in CHECK_ROWS chunks (here the
    plain versions, so the difference is 0 and both read the plain
    versions' bound), twice, bit for bit; the backward of both modes (here
    the closed form) against float64 autograd, twice, bit for bit, the
    training forward equal to the inference one (no saved softmax on the
    CPU); ECAPA's embed path at the cut widths launching B6 once, B8 30
    times and ASP once in each mode; the timing rows, the backward's among
    them; the three entries of the kernels line."""
    _, _, records = rehearsal
    phase = next(r for r in records if r.get("phase") == "asp_kernels")
    assert [(c["kernel"], c["shape"]) for c in phase["checks"]] == [
        ("asp_stats", [150, 37, 24]), ("asp_global", [150, 37, 24]),
        ("asp_bwd", [150, 37, 24]), ("asp_bwd_global", [150, 37, 24])]
    for c in phase["checks"][:2]:
        assert c["max_abs_err"] == 0.0 and c["repeats_bit_for_bit"]
        assert max(c["mean_err_over_bound"], c["var_err_over_bound"]) <= 1.0
        assert [c["mean_err_over_bound"], c["var_err_over_bound"]] == c["plain_err_over_bound"]
    for c in phase["checks"][2:]:
        assert 0.0 < c["max_row_rel_err"] <= cs.ASP_BWD_RTOL and c["repeats_bit_for_bit"]
    assert phase["checks"][2]["training_forward_bit_for_bit"]
    assert phase["checks"][2]["saved_softmax"] is None
    nothing = {name: 0 for name in cs.KERNELS}
    # the forwards: check_asp's two a mode; the backward check's inference
    # launch and two training forwards (weighted), two unweighted; four backwards
    assert phase["launches"] == {**nothing, "asp_stats": 5, "asp_global": 4, "asp_bwd": 4}
    embed = phase["ecapa_embed"]
    assert embed["launches"] == {**nothing, "log_mel": 1, "log_mel_dft": 1, "conv_blockn": 30,
                                 "asp_stats": 1, "asp_global": 1}
    assert embed["min_cosine_vs_plain_stats"] >= cs.ASP_EMBED_MIN_COSINE
    assert embed["channels"] == [256, 256, 256, 256, 768]
    for name in ("asp_stats", "asp_global"):
        row = phase["timing"][name]
        assert row["bound_by"] == "bytes" and row["library_ms"] is None
        assert {"ms", "plain_ms", "bound_ms", "bound_share"} <= set(row)
    assert set(phase["backward_timing"]) == {"asp_bwd", "asp_bwd_global"}
    for row in phase["backward_timing"].values():
        assert row["shape"] == [150, 37, 24] and row["bound_by"] == "bytes"
        assert {"ms", "plain_ms", "bound_ms", "bound_share"} <= set(row)
    by_name = {k["name"]: k for k in records[-2]["kernels"]}
    for name, counter, checked in (("asp_stats", "launches", 5),
                                   ("asp_global", "global_launches", 4)):
        k = by_name[name]
        assert k["launches_by_path"] == {"asp_kernels": checked, "ecapa_embed": 1,
                                         "ecapa_train": 1}
        assert k["source"] == "voicemap_tpu_torch/csrc/asp_stats.cu"
        assert k["replaces"] == "none: the port's own configuration"
        assert k["max_abs_err"] == 0.0 and k["library_ms"] is None
        assert cs.KERNELS[name][1] == counter
    k = by_name["asp_bwd"]
    assert k["launches_by_path"] == {"asp_kernels": 4, "ecapa_train": 2}
    assert cs.KERNELS["asp_bwd"][1] == "backward_launches"
    assert k["source"] == "voicemap_tpu_torch/csrc/asp_stats.cu"
    assert 0.0 < k["max_abs_err"] and k["library_ms"] is None and k["bound_by"] == "bytes"
    both = phase["backward_timing"]
    assert k["ms"] == pytest.approx(both["asp_bwd"]["ms"] + both["asp_bwd_global"]["ms"])
    assert k["bound_ms"] == pytest.approx(both["asp_bwd"]["bound_ms"]
                                          + both["asp_bwd_global"]["bound_ms"])


def test_the_ecapa_train_phase_runs_on_the_cpu(rehearsal):
    """One ``make_ecapa_train_step`` at the cut widths and ECAPA_TRAIN_BATCH:
    B1 once, B6 once (its DFT route), ASP's forward once in each mode and
    its backward twice, nothing else of the kernels; the losses finite."""
    _, _, records = rehearsal
    phase = next(r for r in records if r.get("phase") == "ecapa_train")
    nothing = {name: 0 for name in cs.KERNELS}
    assert phase["launches"] == {**nothing, "gather_whiten": 1, "log_mel": 1, "log_mel_dft": 1,
                                 "asp_stats": 1, "asp_global": 1, "asp_bwd": 2}
    assert phase["batch"] == 6 and phase["channels"] == [256, 256, 256, 256, 768]
    assert all(math.isfinite(v) for v in phase["losses"])


def test_the_config_4_training_and_corpus_phases_run_on_the_cpu(rehearsal):
    """Config #4's train slice (B1 1 and B6 1 a step, the evaluation B1 and
    B6, the step held in f32 and reported in bf16) and its timing; the
    corpus written to disk and ``fit(cfg)`` from it with no store through
    both pipelines (B1 on the device pipeline only) and config #2's
    streaming run; the streamed tables (no B1) against the device store's."""
    code, _, records = rehearsal
    assert code == 0
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    nothing = {name: 0 for name in cs.KERNELS}
    steps_run = 12
    mel = by_phase["mel_train_slice"]
    assert mel["launches"] == {**nothing, "gather_whiten": steps_run, "log_mel": steps_run}
    assert mel["eval_launches"] == {**nothing, "gather_whiten": 2, "log_mel": 2}
    assert mel["batch"] == 16 and mel["loss_last5_mean"] < mel["loss_first5_mean"]
    assert mel["plain_steps"]["float32"]["held"] and not mel["plain_steps"]["bfloat16"]["held"]
    assert mel["plain_steps"]["float32"]["min_grad_cosine"] >= cs.STEP_MIN_COSINE
    assert "val_1-shot_acc" in mel["final_record"]
    timing = by_phase["mel_train_timing"]
    assert [r["batch"] for r in timing["steps"]] == [4, 16]
    assert all({"step_ms", "utt_per_s", "peak_mem_gb", "idle_share"} <= set(r)
               for r in timing["steps"])
    corpus = by_phase["corpus_slice"]
    assert corpus["corpus"]["files"] == 36 and corpus["corpus"]["write_seconds"] > 0
    per_step = {"conv_block0_train": steps_run, "conv_block0_train_bwd": steps_run,
                "pool_fwd": 3 * steps_run, "route_bwd": 3 * steps_run,
                "bn_apply": 4 * steps_run, "bn_grad": 4 * steps_run}
    runs = corpus["runs"]
    assert runs["device"]["launches"] == {**nothing, **per_step, "gather_whiten": steps_run}
    assert runs["streaming"]["launches"] == {**nothing, **per_step}
    for name in ("device", "streaming"):
        assert runs[name]["eval_launches"] == {**nothing, "gather_whiten": 1}
        assert runs[name]["loss_last5_mean"] < runs[name]["loss_first5_mean"]
    assert runs["siamese_streaming"]["launches"] == {
        **nothing, "conv_block0_train": 3, "conv_block0_train_bwd": 3, "pool_fwd": 9,
        "route_bwd": 9, "bn_apply": 12, "bn_grad": 12}
    assert runs["siamese_streaming"]["eval_launches"] == {**nothing, "gather_whiten": 1,
                                                          "weighted_l1": 1}
    assert corpus["decode"]["files"] == 18 and corpus["decode"]["read_batch_files_per_s"] > 0
    assert [(r["batch"], r["pipeline"]) for r in corpus["train_steps"]] == [
        (b, p) for b in (4, 8) for p in ("device", "streaming", "streaming_prefetched")]
    streamed = by_phase["streaming_embed"]
    assert streamed["streaming_bf16"]["launches"] == {**nothing, "conv_block0": 1,
                                                      "conv_blockn": 3}
    assert streamed["streaming_int8"]["launches"] == {**nothing, "conv_block0": 1,
                                                      "quant_block": 3}
    assert streamed["streaming_int8"]["calibration_rows"] == 18
    assert streamed["streaming_mel"]["launches"] == {**nothing, "log_mel": 1}
    for path in ("streaming_bf16", "streaming_int8", "streaming_mel"):
        assert streamed[path]["min_cosine_vs_device_store"] >= cs.TABLE_MIN_COSINE


def test_the_protocol_slice_runs_on_the_cpu(rehearsal):
    """protocol_slice: the five CLIs in-process on a WAV corpus (train-clean-100
    6 × 4, dev-clean and test-clean 12 × 7 here), each command's argv and
    launches: the soak checkpoint trained, then resumed (per step B1 1, B4 1,
    B5 1, B7 3 + 3, per evaluation B1 a chunk); the protocol in bf16 (B1 a
    chunk) and int8 (B1 for calibration and table, B2, B3 × 3), the gate
    (both), the sweep with --fast (B1, B2, B8 × 3, twice: the verification
    embeds its own table), config #2 (B9 at each evaluation, six in its
    protocol), the two embeds and the PCA; the records in form; the paths in
    the kernels line."""
    _, _, records = rehearsal
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    nothing = {name: 0 for name in cs.KERNELS}
    rec = by_phase["protocol_slice"]
    assert rec["card"] == "CPU rehearsal, 0 W" and rec["soak_steps"] == [4, 6]
    commands = {c["name"]: c for c in rec["commands"]}
    assert list(commands) == ["train_classifier_0", "train_classifier_1", "evaluate_protocol",
                              "evaluate_protocol_int8", "evaluate_int8_gate", "evaluate_sweep",
                              "train_siamese", "evaluate_siamese_protocol",
                              "embed_int8_save_qvars", "embed_qvars", "visualize_embeddings"]
    for c in commands.values():
        assert c["argv"][:2] == ["--device", "cpu"] and c["seconds"] > 0
        assert c["argv"][4:8] == ["--filters", "32", "--embedding-dim", "16"]
    train = commands["train_classifier_0"]["argv"]
    assert train[train.index("--batch-size") + 1] == "8"
    assert train[train.index("--val-subsets") + 1] == "dev-clean"
    assert commands["train_classifier_1"]["argv"][-2:] == ["--num-steps", "6"]
    assert commands["evaluate_int8_gate"]["argv"][-3:] == [
        "--protocol", "--allow-corpus-mismatch", "--int8-gate"]
    per_step = {"conv_block0_train": 1, "conv_block0_train_bwd": 1, "pool_fwd": 3,
                "route_bwd": 3, "bn_apply": 4, "bn_grad": 4}
    assert commands["train_classifier_0"]["launches"] == {
        **nothing, **{k: 4 * v for k, v in per_step.items()}, "gather_whiten": 4 + 2}
    assert commands["train_classifier_1"]["launches"] == {
        **nothing, **{k: 2 * v for k, v in per_step.items()}, "gather_whiten": 2 + 1}
    assert commands["evaluate_protocol"]["launches"] == {**nothing, "gather_whiten": 2}
    int8 = {**nothing, "gather_whiten": 4, "conv_block0": 2, "quant_block": 6}
    assert commands["evaluate_protocol_int8"]["launches"] == int8
    assert commands["evaluate_int8_gate"]["launches"] == {**int8, "gather_whiten": 6}
    assert commands["evaluate_sweep"]["launches"] == {
        **nothing, "gather_whiten": 2, "conv_block0": 2, "conv_blockn": 6}
    assert commands["train_siamese"]["launches"] == {
        **nothing, **{k: 3 * v for k, v in per_step.items()}, "gather_whiten": 2 * 3 + 1,
        "weighted_l1": 1}
    assert commands["evaluate_siamese_protocol"]["launches"] == {
        **nothing, "gather_whiten": 2, "weighted_l1": 6}
    assert commands["embed_int8_save_qvars"]["launches"] == {
        **nothing, "gather_whiten": 2, "conv_block0": 1, "quant_block": 3}
    assert commands["visualize_embeddings"]["launches"] == {**nothing, "gather_whiten": 1}
    assert [r["step"] for r in rec["soak_records"]] == [2, 4, 6]
    for key, int8_flag in (("protocol_bf16", False), ("protocol_int8", True),
                           ("siamese_protocol", False)):
        assert len(rec[key]) == 6 and all(r["int8"] is int8_flag for r in rec[key])
        assert all(r["key_stream"] == "threefry2x32-partitionable (numpy replay)"
                   for r in rec[key])
    gate = rec["int8_gate"]
    assert gate["int8_accuracy_gate"] in ("pass", "fail") and len(gate["checks"]) == 8
    assert rec["int8_gate_exit"] == (0 if gate["int8_accuracy_gate"] == "pass" else 2)
    assert all({"base", "int8", "diff", "tolerance", "agree"} <= set(c) for c in gate["checks"])
    assert [p["k_way"] for p in rec["sweep"] if "skipped" in p] == [13, 14] * 2
    assert 0 <= rec["sweep_verification"]["auc"] <= 1
    assert rec["embed"] == {"shape": [84, 16], "int8_tables_equal": True}
    assert set(rec["replay_host_ms"]) == {"tasks_500_1shot_5way", "tasks_500_5shot_5way",
                                          "tasks_500_1shot_10way", "pairs_2000"}
    assert rec["batch1_request_ms"]["step"] is not None
    by_name = {k["name"]: k for k in records[-2]["kernels"]}
    assert by_name["gather_whiten"]["launches_by_path"]["cli_train"] == 9
    assert by_name["conv_block0"]["launches_by_path"]["cli_sweep"] == 2
    assert {p: by_name["conv_block0_int8"]["launches_by_path"][p]
            for p in ("cli_protocol_int8", "cli_int8_gate", "cli_embed")} == {
        "cli_protocol_int8": 2, "cli_int8_gate": 2, "cli_embed": 2}
    assert by_name["route_bwd"]["launches_by_path"]["cli_siamese_train"] == 9


def test_the_pod_and_dp_slices_run_on_the_cpu(rehearsal):
    """pod_slice (config #5 at world size 1, here on gloo): the manifest's
    four entries in bf16 (B1 once a pod_evaluate, one embed chunk) and int8
    (B1, B2, B3 × 3), config #2's head scoring (B1, B9), each accuracy the
    single-device one; dp_slice: the DP step's launches (B1 1, B4 1, B5 1,
    B7 3 + 3 a step), held against the single-device step, fit(dp="on")
    warning at world size 1; both groups destroyed after their phase."""
    code, _, records = rehearsal
    assert code == 0
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    nothing = {name: 0 for name in cs.KERNELS}
    pod = by_phase["pod_slice"]
    assert pod["backend"] == "gloo" and pod["world_size"] == 1
    assert pod["store"]["synthetic"] and pod["store"]["utterances"] == 84
    assert pod["settings"] == [[1, 5], [5, 5], [1, 5], [1, 10]]
    paths = pod["paths"]
    assert paths["pod_bf16"]["launches"] == {**nothing, "gather_whiten": 4}
    assert paths["pod_int8"]["launches"] == {**nothing, "gather_whiten": 4, "conv_block0": 4,
                                             "quant_block": 12}
    assert paths["pod_siamese"]["launches"] == {**nothing, "gather_whiten": 1,
                                                "weighted_l1": 1}
    for rec in paths.values():
        assert rec["accuracy"] == rec["single_device_accuracy"]
    assert pod["distances"] == {"shape": [84, 84, 16], "held": "equal"}
    assert set(pod["scorer_ms"]) == {"tasks_498_1shot_5way", "tasks_2000_1shot_5way"}
    assert set(pod["collective_ms"]) == {"all_gather_table", "all_reduce_scalar"}
    dp = by_phase["dp_slice"]
    steps_run = 12
    assert dp["launches"] == {**nothing, "gather_whiten": steps_run,
                              "conv_block0_train": steps_run,
                              "conv_block0_train_bwd": steps_run,
                              "pool_fwd": 3 * steps_run, "route_bwd": 3 * steps_run,
                              "bn_apply": 4 * steps_run, "bn_grad": 4 * steps_run}
    assert dp["loss_last5_mean"] < dp["loss_first5_mean"]
    held = dp["dp_vs_single_step"]
    assert held["held"] and held["loss_dp"] == held["loss_single"]
    assert held["min_grad_cosine"] >= cs.STEP_MIN_COSINE
    assert [t["step"] for t in dp["step_turns"]] == ["single", "dp", "dp", "single"]
    assert "single attached device" in dp["fit_dp_on"]["warning"]
    assert dp["fit_dp_on"]["launches"]["conv_block0_train"] == 3
    assert not torch.distributed.is_initialized()
    assert by_phase["total"]["seconds"] > 0
    by_name = {k["name"]: k for k in records[-2]["kernels"]}
    assert by_name["gather_whiten"]["launches_by_path"]["pod_int8"] == 4
    assert by_name["conv_block0_int8"]["launches_by_path"]["pod_int8"] == 4


def test_the_int8_recompute_and_raw_store_phases_run_on_the_cpu(rehearsal):
    """int8_train_slice (per step B1 1, B4 1, B5 1, B3's train epilogue 3,
    B7 3 + 3; the evaluation B1 only; the all-kernel step reported, each
    of its own kernels' steps held),
    recompute_train_slice (B1 1, B4 1, B5 1, B8 3, B7's index mode 3 + 3),
    raw_store_slice (no B1 anywhere; the chain against the CPU and, at
    offset 0, against B1); B3's train epilogue, B7's index mode and B8 with
    its rows in train_kernels; their entries in the kernels line."""
    code, _, records = rehearsal
    assert code == 0
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    nothing = {name: 0 for name in cs.KERNELS}
    steps_run = 12
    per_step = {"gather_whiten": 1, "conv_block0_train": 1, "conv_block0_train_bwd": 1,
                "bn_apply": 4, "bn_grad": 4}
    int8 = by_phase["int8_train_slice"]
    assert int8["blockn"] == "fused_int8"
    assert int8["launches"] == {**nothing, **{k: steps_run * v for k, v in per_step.items()},
                                "quant_block_train": 3 * steps_run, "pool_fwd": 3 * steps_run,
                                "route_bwd": 3 * steps_run}
    assert int8["eval_launches"] == {**nothing, "gather_whiten": 2}
    assert int8["loss_last5_mean"] < int8["loss_first5_mean"]
    rec = by_phase["recompute_train_slice"]
    assert rec["launches"] == {**nothing, **{k: steps_run * v for k, v in per_step.items()},
                               "conv_blockn": 3 * steps_run, "pool_fwd_idx": 3 * steps_run,
                               "route_bwd_idx": 3 * steps_run}
    assert rec["loss_last5_mean"] < rec["loss_first5_mean"]
    # the int8 step through every kernel is reported; each of its own
    # kernels alone is held, in both dtypes; the recompute step is held
    assert not any(r["held"] for r in int8["plain_steps"].values())
    assert set(int8["kernel_steps"]) == {"quant_block_train", "b7"}
    for held in (*int8["kernel_steps"].values(), rec["plain_steps"]):
        assert held["float32"]["held"] and held["bfloat16"]["held"]
        assert min(r["min_grad_cosine"] for r in held.values()) >= cs.STEP_MIN_COSINE
    raw = by_phase["raw_store_slice"]
    assert raw["launches"] == {**nothing, "conv_block0_train": 4, "conv_block0_train_bwd": 4,
                               "pool_fwd": 12, "route_bwd": 12, "bn_apply": 16, "bn_grad": 16}
    assert raw["eval_launches"] == nothing and raw["store"]["downsampling"] == 0
    assert raw["chain_vs_cpu"]["max_abs_err"] <= cs.RAW_CHAIN_ATOL
    assert raw["chain_vs_cpu"]["offsets_off_the_decimation_grid"] > 0
    checks = by_phase["train_kernels"]["checks"]
    qtrain = [c for c in checks if c["kernel"] == "quant_block_train"]
    assert len(qtrain) == 2 * 3 + len(cs.DILATED_BLOCKS) + len(cs.QTRAIN_EDGES)
    assert all(c["max_abs_err"] == 0.0 for c in qtrain)
    assert [c["dtype"] for c in qtrain[:2]] == ["bfloat16", "float32"]
    assert [c["dilation"] for c in qtrain[6:6 + len(cs.DILATED_BLOCKS)]] == [
        d for *_, d, _ in cs.DILATED_BLOCKS]
    assert {c["cin"] for c in qtrain} >= {32}
    idx = [c for c in checks if c.get("mode") == "idx"]
    assert [(c["B"], c["pool"], c["rows"]) for c in idx if c["kernel"] == "route_bwd_idx"][
        ::2][6:] == [(e[0], e[3], e[5]) for e in cs.ROUTING_EDGES]
    assert all(c["max_abs_err"] == 0.0 for c in idx if c["kernel"] == "route_bwd_idx"
               and "rel_err" not in c)
    rows8 = [c for c in checks if c.get("rows") == "(b, 1, 0)"]
    assert len(rows8) == 3 and all(c["err_over_bound"] <= 1.0 for c in rows8)
    launches = by_phase["train_kernels"]["launches"]
    assert launches["pool_fwd_idx"] > 0 and launches["route_bwd_idx"] > 0
    timing = by_phase["train_timing"]
    assert [r["T"] for r in timing["quant_block_train_blocks"]] == [T for T, *_ in cs.QBLOCKS]
    assert all({"ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(r)
               for r in timing["quant_block_train_blocks"])
    assert [r["C"] for r in timing["routing_idx_blocks"]] == [c for c, _ in cs.TRAIN_BLOCKS]
    by_name = {k["name"]: k for k in records[-2]["kernels"]}
    assert by_name["quant_block_train"]["launches_by_path"] == {"int8_train": 3 * steps_run}
    assert by_name["quant_block_train"]["max_abs_err"] == 0.0
    assert by_name["quant_block_train"]["bound_by"] in ("bytes", "operations")
    for name in ("pool_fwd_idx", "route_bwd_idx"):
        assert by_name[name]["launches_by_path"] == {"recompute_train": 3 * steps_run}
        assert by_name[name]["max_abs_err"] == 0.0
    assert by_name["gather_whiten"]["launches_by_path"]["raw_train"] == 0
    assert by_name["gather_whiten"]["launches_by_path"]["int8_train"] == steps_run


def test_the_mesh_slice_runs_on_the_cpu(rehearsal):
    """mesh_slice at world size 1 (here on gloo) and over four spawned ranks
    on gloo ({data 2, seq 2}, {data 2, model 2}, pp 4, pp 2): every program
    held, the launches a rank (B1 1 for the data × seq step; B2 1 and B8 3
    for the TP embed; B2 on the pipeline's stage 0, B8 on stage 1; none for
    the sequence-parallel embed and the pipeline's train step), the dry
    run's nine fields from rank 0, the group destroyed after the phase."""
    code, lines, records = rehearsal
    assert code == 0
    by_phase = {r["phase"]: r for r in records if "phase" in r}
    nothing = {name: 0 for name in cs.KERNELS}
    mesh = by_phase["mesh_slice"]
    assert mesh["world"] == 4 and mesh["meshes"]["sp_dp_sp"] == {"data": 2, "seq": 2}
    one = mesh["world_1"]
    assert one["backend"] == "gloo"
    assert one["sp"]["rel_err"] <= cs.MESH_SP_RTOL and one["sp"]["seq"] == 1
    assert one["dp_sp"]["single_device"]["min_grad_cosine"] >= cs.MESH_MIN_COSINE
    assert one["dp_sp"]["launches"] == {**nothing, "gather_whiten": 1}
    assert one["tp"]["launches"] == {**nothing, "conv_block0": 1, "conv_blockn": 3}
    assert one["pp"]["stages"] == 1
    assert one["pp_real_refusal"] == "real-encoder pipeline is a 2-stage split; pp=1"
    ranks = mesh["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["sp"]["launches"] == nothing and r["sp"]["seq"] == 2
        assert r["dp_sp"]["launches"] == {**nothing, "gather_whiten": 1}
        assert r["tp"]["launches"] == {**nothing, "conv_block0": 1, "conv_blockn": 3}
        assert r["tp"]["rel_err"] <= cs.MESH_TP_RTOL
        assert r["pp"]["stages"] == 4 and max(r["pp"]["rel_err"].values()) <= cs.MESH_PP_RTOL
        assert r["dp_sp"]["loss"] == ranks[0]["dp_sp"]["loss"]
        assert r["sp"]["staged_bytes"] == 0  # the CPU stages nothing
    held = ranks[0]["dp_sp"]["single_device"]
    assert held["loss_rel_diff"] <= cs.MESH_LOSS_RTOL
    assert min(held["min_grad_cosine"], held["min_stat_cosine"]) >= cs.MESH_MIN_COSINE
    assert np.isfinite(ranks[0]["dp_sp"]["at_config_dropout"]["loss"])
    assert ranks[0]["pp_real"]["eval"]["launches"] == {**nothing, "conv_block0": 2}
    assert ranks[1]["pp_real"]["eval"]["launches"] == {**nothing, "conv_blockn": 3 * 2}
    assert ranks[2]["pp_real"] == {"seconds": ranks[2]["pp_real"]["seconds"]}
    for r in ranks[:2]:
        assert r["pp_real"]["train"]["launches"] == nothing
        assert max(r["pp_real"]["train"]["rel_err"].values()) <= cs.MESH_PPR_GRAD_RTOL
    assert mesh["launches"]["dp_sp_train"] == {**nothing, "gather_whiten": 4}
    assert mesh["launches"]["tp_embed"] == {**nothing, "conv_block0": 4, "conv_blockn": 12}
    assert mesh["launches"]["pp_real_eval"] == {**nothing, "conv_block0": 2, "conv_blockn": 6}
    assert mesh["launches"]["sp_embed"] == mesh["launches"]["pp_real_train"] == nothing
    line = mesh["dryrun_line"]
    assert line.startswith("dryrun_multichip ok: 4 devices, dp loss=") and line in lines
    assert tuple(ranks[0]["dryrun"]["fields"]) == dryrun.FIELDS
    assert line in mesh["stdout_tail"][0]
    assert not torch.distributed.is_initialized()
    by_name = {k["name"]: k for k in records[-2]["kernels"]}
    assert by_name["gather_whiten"]["launches_by_path"]["dp_sp_train"] == 4
    assert by_name["conv_block0"]["launches_by_path"]["tp_embed"] == 4
    assert by_name["conv_block0"]["launches_by_path"]["pp_real_eval"] == 2
