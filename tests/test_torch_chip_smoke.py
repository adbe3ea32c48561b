"""chip_smoke.py's phases rehearsed on the CPU at a tiny size.

The script routes every tensor through ``chip_smoke.DEVICE``; here that is the
CPU, the kernels' plain versions stand in for the kernels (and count as their
launches), the build and the CUDA-event timers are stubbed, and the sizes
and the configs are cut down (filters 32, 0.128 s fragments, train batches
of 8, 12 train steps, B8 and B3 at (100, 32 → 64), (50, 64 → 96) and
(25, 96 → 128), and at their edge shapes as the card runs them; config #4 at 0.15 s, 16 frames, 32 mels; config #2 at
the same 0.128 s and filters 32, 8 pairs a train step, 40 verification
pairs, B9 timed at (1, 40, 36, 16) and (50, 1, 5, 16)); the train
policies resolve as they do on the card (B4/B5 and the fused blocks-1+ op).
What this shows
is the control flow, the shapes and the records of every phase, the
``kernels`` line's keys and the last line; what the kernels compute on the
card only the script itself, run there, shows.
"""

import json
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, MelConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.ops import (
    cuda_conv, cuda_conv_train, cuda_distance, cuda_melspec, cuda_preprocess, cuda_quant_block,
    cuda_routing,
)
from voicemap_tpu_torch.train import steps

KERNEL_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture
def on_the_cpu(monkeypatch):
    small = ExperimentConfig(data=DataConfig(seconds=0.128, downsampling=4),
                             encoder=EncoderConfig(filters=32, embedding_dim=16))
    small_mel = ExperimentConfig(name="melspec_2d", mode="melspec2d",
                                 data=DataConfig(seconds=0.15, downsampling=1),
                                 encoder=EncoderConfig(filters=32, embedding_dim=16),
                                 mel=MelConfig(hop_length=128, win_length=384, n_mels=32))
    small_siamese = ExperimentConfig(name="siamese_verification", mode="siamese",
                                     data=DataConfig(seconds=0.128, downsampling=4),
                                     encoder=EncoderConfig(filters=32, embedding_dim=16,
                                                           dropout=0.0),
                                     siamese=SiameseConfig(distance_metric="weighted_l1"),
                                     train=TrainConfig(batch_size=64, loss="bce"))
    for name, value in (("DEVICE", "cpu"), ("BATCH", 512), ("STORE_T", 2600), ("FRAG", 400),
                        ("CHECK_ROWS", 64), ("SWEEP", (1, 8, 512)),
                        ("QBLOCKS", ((100, 32, 64, False), (50, 64, 96, False),
                                     (25, 96, 128, True))),
                        ("classifier_baseline", lambda: small),
                        ("melspec_2d", lambda: small_mel), ("MEL_FRAG", 2400),
                        ("MEL_EDGES", ((1, 2400, dict(n_mels=16)), (5, 2399, {}),
                                       (5, 2400, dict(hop_length=160, win_length=400)),
                                       (2, 384, {}), (2, 1501, {}),
                                       (4, 2400, dict(n_fft=256, win_length=256,
                                                      hop_length=128)),
                                       (2, 2400, dict(n_fft=1024, win_length=1024,
                                                      hop_length=256)),
                                       (3, 2400, dict(n_fft=400, win_length=400,
                                                      hop_length=160)))),
                        ("B2_WIDE", (300, 64, 16)),
                        ("TRAIN_BATCH", 8), ("TRAIN_C0", 16), ("TRAIN_STEPS", 12),
                        ("TRAIN_BLOCKS", ((64, 100), (96, 50), (128, 24))),
                        ("TRAIN_TIMING_BATCHES", (4, 8)),
                        ("siamese_config", lambda: small_siamese),
                        ("B9_TIMING", (1, 40, 36, 16)), ("B9_NSHOT", (50, 1, 5, 16)),
                        ("SIAMESE_PAIRS", 40), ("SIAMESE_BATCH", 8),
                        ("card_line", lambda: "CPU rehearsal, 0 W")):
        monkeypatch.setattr(cs, name, value)
    # The policies as they resolve on the card: B4/B5, and the fused
    # blocks-1+ op unless the config says otherwise.
    monkeypatch.setattr(steps, "resolve_fused_block0", lambda cfg, model: True)
    monkeypatch.setattr(steps, "resolve_blockn", lambda cfg, device: (
        "jnp" if cfg.train.use_fused_blockn is False else "fused"))
    # The plain versions count as launches where the wrappers call them, on
    # the counter of the kernel the card would launch: B2's, B4's and B5's
    # f32-GEMM kernels for a float32 GEMM, B6's DFT route for an n_fft it takes.
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
    for mod, ref, wrapper in ((cuda_conv, "conv_blockn_reference", cuda_conv.conv_blockn),
                              (cuda_quant_block, "quant_block_stage_reference",
                               cuda_quant_block.quant_block_stage),
                              (cuda_preprocess, "gather_whiten_reference",
                               cuda_preprocess.gather_whiten),
                              (cuda_quant_block, "quant_block_reference",
                               cuda_quant_block.quant_block),
                              (cuda_routing, "pool_fwd_reference", cuda_routing.pool_fwd),
                              (cuda_routing, "route_bwd_reference", cuda_routing.route_bwd),
                              (cuda_distance, "weighted_l1_reference",
                               cuda_distance.weighted_l1)):
        def counted(*a, _ref=getattr(mod, ref), _w=wrapper, **k):
            _w.launches += 1
            return _ref(*a, **k)
        monkeypatch.setattr(mod, ref, counted)
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
    monkeypatch.setattr(cs._build, "build", lambda: (Path("none.so"), 0.0, ""))
    monkeypatch.setattr(cs._build, "library", lambda: None)
    for name, value in (("is_available", lambda: True), ("synchronize", lambda *a: None),
                        ("get_device_name", lambda *a: "cpu"), ("device_count", lambda: 1),
                        ("max_memory_allocated", lambda *a: 0),
                        ("reset_peak_memory_stats", lambda *a: None),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)


def test_every_phase_runs_on_the_cpu_at_a_tiny_size(on_the_cpu, capsys):
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == lines[-3] == "CPU rehearsal, 0 W"
    records = [json.loads(line) for line in lines if line.startswith("{")]
    phases = [r["phase"] for r in records if "phase" in r]
    assert phases == ["device", "build", "kernels", "train_kernels", "slice", "int8_slice",
                      "int8_fidelity_gate", "train_slice", "timing", "attribution",
                      "train_layout", "train_timing",
                      "mel_kernels", "mel_bf16_slice", "mel_int8_slice", "mel_int8_fidelity",
                      "mel_timing", "siamese_kernels", "siamese_bf16_slice",
                      "siamese_int8_slice", "verification", "score_support",
                      "siamese_train_slice", "siamese_timing"]
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
    assert train["launches"] == {**nothing, "gather_whiten": steps_run,
                                 "conv_block0_train": steps_run,
                                 "conv_block0_train_bwd": steps_run,
                                 "pool_fwd": 3 * steps_run, "route_bwd": 3 * steps_run}
    # the evaluation embeds through the model's own forward: B1, no B2 or B8
    assert train["eval_launches"] == {**nothing, "gather_whiten": 2}
    assert train["loss_last5_mean"] < train["loss_first5_mean"]
    assert train["plain_step"]["min_grad_cosine"] >= cs.STEP_MIN_COSINE
    timing = by_phase["train_timing"]
    assert [(r["batch"], r["blockn"]) for r in timing["train_step_turns"]] == [
        (b, p) for b in (4, 8) for p in ("jnp", "fused", "fused", "jnp")]
    assert [(r["batch"], r["blockn"], len(r["turns_ms"])) for r in timing["train_step"]] == [
        (4, "jnp", 2), (4, "fused", 2), (8, "jnp", 2), (8, "fused", 2)]
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
    f32_route = [c for c in train_checks if c.get("route") == "float32 GEMM"]
    assert [c["kernel"] for c in f32_route] == ["conv_block0_train"] * 3 + [
        "conv_block0_train_bwd"] * 2
    assert f32_route[0]["max_abs_err"] == 0.0
    launches = by_phase["train_kernels"]["launches"]
    assert launches["conv_block0_train_f32"] == launches["conv_block0_train_bwd_f32"] == 1
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
                                                [2, 2400], [3, 2400], [4, 2400], [4, 2400]]
    assert all(c["max_abs_err"] <= cs.B6_ATOL for c in mel_checks[1:])
    # n_fft 512, 256 and 1024 take the FFT kernel, n_fft 400 the DFT kernel
    assert [(c["n_fft"], c["route"]) for c in mel_checks[1:]] == (
        [(512, "fft")] * 6 + [(256, "fft"), (1024, "fft"), (400, "dft"), (512, "fft"),
                              (400, "dft")])
    assert mel_checks[1]["max_abs_err_vs_rfft_route"] <= cs.B6_ATOL
    assert mel_checks[-1]["rows"][:2] == ["tone 440 Hz", "zeros"]
    assert by_phase["mel_kernels"]["launches"]["log_mel_dft"] == 2
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
                                  "pool_fwd": 3 * steps_run, "route_bwd": 3 * steps_run}
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
    assert {"ms", "plain_ms", "broadcast_ms", "library_ms", "bound_ms"} <= set(
        stiming["weighted_l1"]["timing"])
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
                                            "conv_blockn", "quant_block_stage"]
    for k in kernels:
        assert KERNEL_KEYS <= set(k) and k["launches"] > 0 and k["bound_by"] in (
            "bytes", "operations")
    by_name = {k["name"]: k for k in kernels}
    assert by_name["pool_fwd"]["launches_by_path"] == {"train": 3 * steps_run,
                                                       "siamese_train": 3 * steps_run}
    assert by_name["gather_whiten"]["launches_by_path"]["train"] == steps_run
    assert by_name["gather_whiten"]["launches_by_path"]["siamese_train"] == 2 * steps_run
    assert by_name["weighted_l1"]["launches_by_path"] == {
        "siamese_bf16": 1, "siamese_int8": 1, "verification": 1, "score_support": 1}
    assert by_name["weighted_l1"]["launches"] == 4
    assert by_name["weighted_l1"]["max_abs_err"] == 0.0
    assert by_name["weighted_l1"]["library_ms"] is not None
    assert by_name["quant_block"]["launches_by_path"] == {"int8": 6, "siamese_int8": 6}
    assert by_name["conv_blockn"]["launches_by_path"] == {"bf16": 6, "siamese_bf16": 6}
    assert by_name["conv_blockn"]["library_ms"] is not None
    assert by_name["conv_blockn"]["source"] == "voicemap_tpu_torch/csrc/conv_blockn.cu"
    assert list(by_name["quant_block_stage"]["launches_by_path"]) == ["attribution"]
    assert by_name["quant_block_stage"]["max_abs_err"] == 0.0
    assert by_name["conv_block0_train_bwd"]["library_ms"] is not None
    # B4's and B5's f32 route runs on no path: the train-kernels phase's count
    for name in ("conv_block0_train_f32", "conv_block0_train_bwd_f32"):
        assert by_name[name]["launches_by_path"] == {"train_kernels": 1}
    assert by_name["conv_block0_train_bwd_f32"]["library_ms"] is not None
    assert by_name["conv_block0_train"]["launches_by_path"] == {"train": steps_run,
                                                                "siamese_train": steps_run}
    assert by_name["log_mel"]["launches_by_path"] == {"mel_bf16": 2, "mel_int8": 2}
    assert by_name["log_mel_dft"]["launches_by_path"] == {"mel_kernels": 2}
    assert by_name["conv_block0_f32"]["launches_by_path"] == {"kernels": 3}
    assert by_name["conv_block0"]["library_ms"] is not None
    assert by_name["log_mel"]["library_ms"] is not None
    assert by_name["gather_whiten"]["launches_by_path"]["mel_int8"] == 2
    assert records[-1] == {"ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}}
