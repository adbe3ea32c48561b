"""ASP's one-pass statistics on the card (``ops/cuda_asp.asp_stats``,
``csrc/asp_stats.cu``) against float64 sums. Run on a machine with a card,
from the repository root:

    python -m pytest --noconftest -m card tests/test_torch_asp_stats_card.py -q

(``--noconftest``: the suite's ``conftest.py`` imports JAX, which these tests
do not need.) Without a card every test skips.

- Both modes at the benchmark cell's shape (2,048 × 298 × 3,072, bf16) and
  at ragged ones (B 1 and 1,915; T 1, 7 and 1,001; C 8), in bf16 and f32,
  with logits of unit spread and with logits spread over ±60 whose maximum
  arrives late in T (the online softmax rescales again and again): each
  mean and each std, through its square, within its f32 summation bound of
  the float64 statistics (``chip_smoke.asp_err_over_bound``: the mean
  within ``(2γ_n + u)·Σw|h|``, std² within ``8γ_n·(Σw·h² + eps)``, w the
  float64 softmax or 1/T, γ_n = n·u / (1 − n·u), n = T + 24); the plain
  versions read within the same bounds.
- Two launches agree bit for bit (the warps merge in a fixed order).
- The wrapper's refusals on the card (a misaligned input, besides the CPU
  tests' cases).
- The backward (both modes' autograd functions, the weighted mode's
  training instantiation and the backward kernel) at the training cell's
  shape (512 × 298 × 3,072) in bf16 and f32 and at ragged ones, against
  float64 autograd through the plain versions' formula: each utterance's
  dh and dlogits within ``BWD_TOL`` of the float64 gradients (relative to
  their norm: bf16 holds the gradients to 2^-9 an element, f32 to its
  ~2^-24 summed over T); an input that needs a gradient goes through the
  backward (the case the refusals held before training); two backward
  launches agree bit for bit; the launch counters.
- A ``fast_embed`` batch at the published widths: one launch in each mode,
  no softmax kernel and no f32 product over MFA's (B, T, 3C) output, and
  ASP's rise of ``torch.cuda.max_memory_allocated`` under B·T·3C·4 bytes.
"""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from portbench import data
from portbench.kinds import embed_ecapa
from voicemap_tpu_torch.models import ecapa
from voicemap_tpu_torch.ops.cuda_asp import (
    asp_stats, attentive_stats_reference, global_stats_reference,
)

REPO = Path(__file__).resolve().parent.parent
CHUNK = 64  # rows of a float64 comparison at once
# (B, T, C, dtype)
SHAPES = [(2048, 298, 3072, torch.bfloat16), (1, 298, 3072, torch.bfloat16),
          (1915, 298, 3072, torch.bfloat16), (16, 1, 3072, torch.bfloat16),
          (16, 7, 3072, torch.bfloat16), (8, 1001, 512, torch.bfloat16),
          (5, 298, 8, torch.bfloat16), (64, 298, 3072, torch.float32),
          (3, 1001, 8, torch.float32), (7, 1, 24, torch.float32)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


@pytest.mark.card
@pytest.mark.parametrize("logits", ["unit", "late"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:3])) + (
    "_bf16" if s[3] == torch.bfloat16 else "_f32"))
def test_both_modes_against_float64_sums(card, shape, logits):
    B, T, C, dtype = shape
    h, x = cs.asp_inputs(B + T + C, B, T, C, dtype, logits)
    counts = (asp_stats.launches, asp_stats.global_launches)
    pooled = asp_stats(h, x)
    mean, std = asp_stats(h)
    torch.cuda.synchronize()
    assert (asp_stats.launches, asp_stats.global_launches) == (counts[0] + 1, counts[1] + 1)
    assert pooled.shape == (B, 2 * C) and mean.shape == std.shape == (B, C)
    assert pooled.dtype == mean.dtype == std.dtype == torch.float32
    worst = [0.0] * 4
    for lo in range(0, B, CHUNK):
        rows = slice(lo, lo + CHUNK)
        hr = h[rows]
        soft = torch.softmax(x[rows].double(), dim=1)
        flat = torch.full(hr.shape, 1.0 / T, dtype=torch.float64, device="cuda")
        got = (cs.asp_err_over_bound(hr, soft, pooled[rows, :C], pooled[rows, C:])
               + cs.asp_err_over_bound(hr, flat, mean[rows], std[rows]))
        worst = [max(a, b) for a, b in zip(worst, got)]
        del soft, flat
    assert max(worst) <= 1.0, worst


@pytest.mark.card
def test_the_plain_versions_agree_within_the_same_bounds(card):
    """The eager versions the kernel replaced read within the same bounds at
    a slice of the cell's shape: the bound is the sums', not the kernel's."""
    h, x = cs.asp_inputs(5, 64, 298, 3072)
    pooled = attentive_stats_reference(h, x)
    mean, std = global_stats_reference(h)
    flat = torch.full(h.shape, 1.0 / 298, dtype=torch.float64, device="cuda")
    soft = torch.softmax(x.double(), 1)
    got = (cs.asp_err_over_bound(h, soft, pooled[:, :3072], pooled[:, 3072:])
           + cs.asp_err_over_bound(h, flat, mean, std))
    assert max(got) <= 1.0, got


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_two_launches_agree_bit_for_bit(card, dtype):
    h, x = cs.asp_inputs(7, 2048 if dtype == torch.bfloat16 else 256, 298, 3072, dtype)
    a, b = asp_stats(h, x), asp_stats(h, x)
    (m1, s1), (m2, s2) = asp_stats(h), asp_stats(h)
    for p, q in ((a, b), (m1, m2), (s1, s2)):
        assert torch.equal(p.view(torch.int32), q.view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("case", ["c_12", "h_transposed", "logits_transposed", "float16",
                                  "dtypes_differ", "misaligned"])
def test_the_wrapper_refuses_on_the_card(card, case):
    h, x = cs.asp_inputs(1, 4, 10, 24, torch.float32, "unit")
    if case == "c_12":
        h, x = h[..., :12].contiguous(), x[..., :12].contiguous()
    elif case == "h_transposed":
        h = h.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "logits_transposed":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "float16":
        h, x = h.half(), x.half()
    elif case == "dtypes_differ":
        x = x.bfloat16()
    else:  # contiguous, but one element off the 16-byte boundary
        h = torch.empty(h.numel() + 1, device="cuda")[1:].view(h.shape).copy_(h)
    with pytest.raises(ValueError, match="asp_stats"):
        asp_stats(h, x)


# Relative error of a gradient row against float64: bf16 out rounds each
# element to 2^-9; f32 carries the sums' ~T·2^-24.
BWD_TOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-4}
BWD_SHAPES = [(512, 298, 3072, torch.bfloat16), (512, 298, 3072, torch.float32),
              (3, 1, 24, torch.bfloat16), (5, 1001, 8, torch.float32)]


def plain_stats(h: torch.Tensor, x) -> tuple:
    """The plain versions' formula, out of place (so autograd runs through
    it): ``(mean, std)`` under the softmax of ``x`` over T, or 1/T."""
    w = torch.softmax(x, dim=1) if x is not None else 1.0 / h.shape[1]
    mean = (w * h).sum(dim=1)
    square = (w * h * h).sum(dim=1)
    return mean, (square - mean * mean).clamp(min=1e-12).sqrt()


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    flat = lambda t: t.double().reshape(t.shape[0], -1)  # noqa: E731
    return (flat(got) - flat(want)).norm(dim=1) / flat(want).norm(dim=1)


@pytest.mark.card
@pytest.mark.parametrize("mode", ["weighted", "global"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s[:3])) + (
    "_bf16" if s[3] == torch.bfloat16 else "_f32"))
def test_the_backward_against_float64_autograd(card, shape, mode):
    B, T, C, dtype = shape
    h, x = cs.asp_inputs(B * 7 + T + C, B, T, C, dtype, "unit")
    g = torch.Generator(device="cuda").manual_seed(B + T)
    gm, gs = (torch.randn(B, C, generator=g, device="cuda") for _ in range(2))
    h.requires_grad_()
    counts = (asp_stats.launches, asp_stats.global_launches, asp_stats.backward_launches)
    if mode == "weighted":
        x.requires_grad_()
        pooled = asp_stats(h, x)
        got = torch.autograd.grad(pooled, [h, x], torch.cat([gm, gs], dim=1))
        want_counts = (counts[0] + 1, counts[1], counts[2] + 1)
    else:
        mean, std = asp_stats(h)
        got = torch.autograd.grad((mean, std), [h], (gm, gs))
        want_counts = (counts[0], counts[1] + 1, counts[2] + 1)
    torch.cuda.synchronize()
    assert (asp_stats.launches, asp_stats.global_launches,
            asp_stats.backward_launches) == want_counts
    assert all(t.dtype == dtype and t.shape == h.shape for t in got)
    worst = 0.0
    for lo in range(0, B, CHUNK):
        rows = slice(lo, lo + CHUNK)
        h64 = h[rows].detach().double().requires_grad_()
        x64 = x[rows].detach().double().requires_grad_() if mode == "weighted" else None
        stats = plain_stats(h64, x64)
        wrt = [h64] + ([x64] if x64 is not None else [])
        want = torch.autograd.grad(stats, wrt, (gm[rows].double(), gs[rows].double()))
        for a, b in zip(got, want):
            worst = max(worst, float(row_errors(a[rows], b).max()))
        del h64, x64, stats, want
    assert worst <= BWD_TOL[dtype], worst


@pytest.mark.card
def test_a_backward_launch_repeats_bit_for_bit(card):
    h, x = cs.asp_inputs(11, 512, 298, 3072, torch.bfloat16, "late")
    h.requires_grad_()
    x.requires_grad_()
    g = torch.randn(512, 2 * 3072, device="cuda")
    a = torch.autograd.grad(asp_stats(h, x), [h, x], g)
    b = torch.autograd.grad(asp_stats(h, x), [h, x], g)
    assert all(torch.equal(p.view(torch.int16), q.view(torch.int16)) for p, q in zip(a, b))


@pytest.mark.card
def test_an_input_that_needs_a_gradient_goes_through_the_backward(card):
    """The case the wrapper refused before the backward existed: under
    autograd the weighted mode's training instantiation runs, and its
    forward equals the inference launch bit for bit."""
    h, x = cs.asp_inputs(1, 4, 10, 24, torch.float32, "unit")
    want = asp_stats(h, x)
    h.requires_grad_()
    got = asp_stats(h, x)
    assert got.requires_grad and torch.equal(got.detach(), want)
    (dh,) = torch.autograd.grad(got.sum(), [h])
    assert dh.shape == h.shape and torch.isfinite(dh).all()


@pytest.fixture(scope="module")
def model_and_rows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    config = json.loads((REPO / "portbench/configs/ecapa_tdnn.json").read_text())
    seed = 2**31 + 53
    cfg = embed_ecapa.experiment_config(config)
    model = embed_ecapa.model(cfg, config, 251, seed, "cuda")
    raw, _ = data.query_pool(data.StoreSpec(32, 32, 3.0, 3.0), seed, 128, 3.0, "cuda")
    return model.encoder, (raw.float() / 32768.0)[..., None]


@pytest.mark.card
def test_a_fast_embed_batch_pools_in_one_pass_each(card, model_and_rows, monkeypatch):
    encoder, x = model_and_rows
    ecapa.fast_embed(encoder, x)  # built and warm
    torch.cuda.synchronize()
    seen = {}
    real_global, real_attentive = ecapa.global_stats, ecapa.attentive_stats

    def spy_global(h):  # ASP's first call: where its memory starts
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen.update(start=torch.cuda.memory_allocated(), shape=tuple(h.shape))
        return real_global(h)

    def spy_attentive(h, logits):  # ASP's last reduction
        out = real_attentive(h, logits)
        torch.cuda.synchronize()
        seen["peak"] = torch.cuda.max_memory_allocated()
        return out

    monkeypatch.setattr(ecapa, "global_stats", spy_global)
    monkeypatch.setattr(ecapa, "attentive_stats", spy_attentive)
    counts = (asp_stats.launches, asp_stats.global_launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        ecapa.fast_embed(encoder, x)
        torch.cuda.synchronize()
    assert (asp_stats.launches - counts[0], asp_stats.global_launches - counts[1]) == (1, 1)
    B, T, C = seen["shape"]
    assert (B, C) == (x.shape[0], 3072)
    events = prof.events()
    kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("asp_stats_kernel" in n for n in kernels) == 2
    assert not [n for n in kernels if "softmax" in n.lower()]
    products = [e for e in events if e.name in ("aten::mul", "aten::mul_")
                and e.input_shapes and list(e.input_shapes[0]) == [B, T, C]]
    assert not products
    assert seen["peak"] - seen["start"] < B * T * C * 4, seen
