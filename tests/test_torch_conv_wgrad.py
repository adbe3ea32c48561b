"""The dilated convs' weight gradient (``ops/cuda_wgrad``) on the CPU.

``conv_wgrad_reference`` (zero-pad, shift, an ``einsum`` a tap) against
``aten.convolution_backward``'s dW in f32 at k = 3 and dilations 1–16, with
T a multiple of no tile, B > 1 and Cin, Cout of 8, 24 and 128; the wrapper
takes it for CPU tensors, launches nothing there and refuses what no conv
is; the fused backward's route to it on the kernel's domain alone; the
kernel's split plan at config #3's dilated blocks; the benchmark's
bound (``portbench/counts_wgrad``) summed over them; and the metric
``dilated_wgrad_roofline.train``, None with no span and a number from the
spans of a traced fused train step of config #3 at a tiny width.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import counts, counts_wgrad
from voicemap_tpu_torch.config import dilated_4khz
from voicemap_tpu_torch.models import fused_train
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.ops import conv_train, cuda_wgrad
from voicemap_tpu_torch.ops.cuda_wgrad import conv_wgrad, conv_wgrad_reference, plan
from voicemap_tpu_torch.utils.profiling import clear_spans, spans

REPO = Path(__file__).resolve().parent.parent
DILATIONS = [1, 2, 4, 8, 16]
CHANNELS = [(8, 24), (24, 128), (128, 8)]
B, T = 3, 131  # T: a multiple of neither the kernel's 128-row stage nor a 64-row one
H100_SMS = 132


def cudnn_dw(x, dz, k, dilation):
    """dW (Cout, Cin, k) of ``conv1d(x, w, padding=h, dilation=d)`` by
    ``aten.convolution_backward`` on the (B, C, T) views."""
    w = torch.zeros(dz.shape[2], x.shape[2], k)
    _, dw, _ = torch.ops.aten.convolution_backward(
        dz.permute(0, 2, 1), x.permute(0, 2, 1), w, None, [1], [dilation * (k - 1) // 2],
        [dilation], False, [0], 1, [False, True, False])
    return dw


def rows(cin, cout, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, T, cin, generator=gen), torch.randn(B, T, cout, generator=gen)


@pytest.mark.parametrize("cin,cout", CHANNELS)
@pytest.mark.parametrize("dilation", DILATIONS)
def test_the_plain_version_matches_convolution_backward(dilation, cin, cout):
    """f32 sums of T·B = 393 terms a tap in two orders: within 1e-5 of the
    largest |dW| (f32 keeps 2^-24 of each partial sum)."""
    x, dz = rows(cin, cout, seed=dilation)
    got = conv_wgrad_reference(x, dz, 3, dilation)
    want = cudnn_dw(x, dz, 3, dilation)
    assert got.shape == (cout, cin, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_the_plain_version_reads_no_row_across_batch_rows():
    """A reach of 2·16 over T = 20: every tap but the centre reads padding
    for most rows, and the rows of the next utterance never."""
    x, dz = torch.randn(2, 20, 8), torch.randn(2, 20, 8)
    got = conv_wgrad_reference(x, dz, 3, 16)
    alone = sum(conv_wgrad_reference(x[b:b + 1], dz[b:b + 1], 3, 16) for b in range(2))
    torch.testing.assert_close(got, alone)
    torch.testing.assert_close(got, cudnn_dw(x, dz, 3, 16), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_wrapper_takes_the_plain_version_on_the_cpu(dtype):
    x, dz = (t.to(dtype) for t in rows(24, 8))
    before = conv_wgrad.launches
    got = conv_wgrad(x, dz, 3, 4)
    assert conv_wgrad.launches == before
    assert got.dtype == torch.float32
    assert torch.equal(got, conv_wgrad_reference(x, dz, 3, 4))


@pytest.mark.parametrize("case", ["batch", "time", "even_k", "dtype", "rank"])
def test_the_wrapper_refuses_what_no_conv_is(case):
    x, dz = rows(8, 8)
    args = {"batch": (x, dz[:2], 3, 2), "time": (x, dz[:, :-1], 3, 2),
            "even_k": (x, dz, 4, 2), "dtype": (x, dz.double(), 3, 2),
            "rank": (x[0], dz[0], 3, 2)}[case]
    with pytest.raises(ValueError):
        conv_wgrad(*args)


ROUTES = {"kernel": (torch.bfloat16, 16, 24, 2, True), "d64": (torch.bfloat16, 16, 16, 64, True),
          "d65": (torch.bfloat16, 16, 16, 65, False), "cin12": (torch.bfloat16, 12, 16, 2, False),
          "cout20": (torch.bfloat16, 16, 20, 4, False), "f32": (torch.float32, 16, 16, 2, False),
          "d1": (torch.bfloat16, 16, 16, 1, False)}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_the_fused_backward_routes_on_the_kernels_domain(case):
    """``FusedBlocknTrain``'s backward takes dW from ``conv_wgrad`` for a
    dilated conv the kernel takes (bf16, d 2–64, channels in eights) and
    from ``aten.convolution_backward`` otherwise (d = 1, d > 64, odd
    channels, f32), where the kernel would refuse on the card; one
    predicate (``wgrad_routed``) names the route, and dW agrees with the
    backward routed all to aten (within bf16's rounding of aten's dW)."""
    dtype, cin, cout, dilation, routed = ROUTES[case]
    assert conv_train.wgrad_routed(dtype, 3, dilation, cin, cout) is routed
    gen = torch.Generator().manual_seed(dilation)
    x = torch.randn(2, cin, 150, generator=gen).to(dtype)
    w = torch.randn(cout, cin, 3, generator=gen) * 0.1
    gy = torch.randn(2, cout, 150, generator=gen)
    calls = []
    real = cuda_wgrad.conv_wgrad

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    def dw():
        wl = w.clone().requires_grad_()
        y, _, _ = conv_train.FusedBlocknTrain.apply(
            x, wl, torch.zeros(cout), torch.ones(cout), torch.zeros(cout), 1, 1e-3, dilation,
            dtype, "none", torch.float32, None, 1.0, 1)
        return torch.autograd.grad((y * gy).sum(), [wl])[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_wgrad, "conv_wgrad", spy)
        got = dw()
        assert calls == ([dilation] if routed else [])
        mp.setattr(conv_train, "wgrad_routed", lambda *_: False)
        want = dw()
    assert calls == ([dilation] if routed else [])
    torch.testing.assert_close(got, want, rtol=0, atol=2 ** -7 * float(want.abs().max()))


def dilated_blocks():
    cfg = json.loads((REPO / "portbench" / "configs" / "dilated_4khz.json").read_text())
    return cfg, [(i, b) for i, b in enumerate(counts.blocks(cfg)) if b["dilation"] > 1]


def test_the_split_plan_at_config_3s_dilated_blocks():
    """One item a CTA on the H100's 132 SMs: 1, 4, 9 and 16 tiles of 128 ×
    128 channels, K cut into 132, 33, 14 and 8 chunks; the slots stay far
    under the scratch cap."""
    _, blocks = dilated_blocks()
    got = [plan(2048, b["T"], b["cin"], b["cout"], H100_SMS) for _, b in blocks]
    assert got == [(132, 1), (33, 4), (14, 9), (8, 16)]
    for splits, tiles in got:
        assert splits * tiles <= H100_SMS
        assert splits * tiles * cuda_wgrad.SLOT_BYTES <= cuda_wgrad.SCRATCH_CAP
    assert plan(1, 7, 8, 8, H100_SMS) == (1, 1)  # never more chunks than stages


def test_the_bound_of_config_3s_dilated_weight_gradients():
    """Block 1 by bytes (x and dz in bf16, dW in f32: 3.146 GB), blocks 3–7
    by operations: 4.756 ms at B = 2048."""
    _, blocks = dilated_blocks()
    bounds = [counts_wgrad.wgrad_bound_s(b, 2048) for _, b in blocks]
    assert [i for i, _ in blocks] == [1, 3, 5, 7]
    assert sum(bounds) * 1e3 == pytest.approx(4.756, abs=5e-4)
    b1 = blocks[0][1]
    assert bounds[0] == pytest.approx((2048 * 3000 * 256 * 2 + 3 * 128 * 128 * 4) / 3.35e12)
    assert bounds[3] == pytest.approx(2048 * counts.conv_flops(blocks[3][1]) / 989e12)
    assert counts.conv_flops(b1) == 2.0 * 3000 * 3 * 128 * 128


def load_metric():
    path = REPO / "portbench" / "metrics" / "dilated_wgrad_roofline.train.py"
    spec = importlib.util.spec_from_file_location("dilated_wgrad_roofline_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def no_records():
    clear_spans()
    yield
    clear_spans()


def test_the_metric_reads_none_without_spans(no_records):
    cfg, _ = dilated_blocks()
    assert load_metric().read(SimpleNamespace(config=cfg)) is None


def test_a_traced_fused_step_of_config_3_leaves_one_span_a_dilated_block(no_records):
    """Config #3 at 16 filters in bf16 under ``blockn="fused"``: the backward
    opens ``conv.wgrad.<i>`` once for each dilated block (1, 3, 5, 7) at the
    batch's rows, calls ``conv_wgrad`` inside it, and the metric reads those
    spans (a host-clock number here, not a device one)."""
    cfg = dilated_4khz()
    model = SpeakerClassifier(dataclasses.replace(cfg.encoder, filters=16,
                                                  compute_dtype="bfloat16"), 5, device="cpu")
    calls = []
    real = cuda_wgrad.conv_wgrad

    def spy(x, dz, k, dilation):
        calls.append((tuple(x.shape), tuple(dz.shape), dilation))
        return real(x, dz, k, dilation)

    x = torch.randn(4, 1024, 1, generator=torch.Generator().manual_seed(0))
    with pytest.MonkeyPatch.context() as mp, profile(activities=[ProfilerActivity.CPU]):
        mp.setattr(cuda_wgrad, "conv_wgrad", spy)
        logits = fused_train.classifier_train_forward(
            model, x, torch.Generator().manual_seed(1), blockn="fused")
        logits.sum().backward()
    records = [r for r in spans() if r.name.startswith("conv.wgrad")]
    assert sorted(r.name for r in records) == [f"conv.wgrad.{i}" for i in (1, 3, 5, 7)]
    assert all(r.rows == 4 and r.ms is not None for r in records)
    assert sorted(d for *_, d in calls) == [2, 4, 8, 16]
    assert all(xs[:2] == dzs[:2] and xs[0] == 4 for xs, dzs, _ in calls)
    pcfg = json.loads((REPO / "portbench" / "configs" / "dilated_4khz.json").read_text())
    value = load_metric().read(SimpleNamespace(config=pcfg))
    assert value is not None and value > 0
