"""ECAPA-TDNN on the card: B8 at ECAPA's shapes, the fast embed at the
published widths against the benchmark's reference, and what a batch
launches. Run on a machine with a card, from the repository root:

    python -m pytest --noconftest -m card tests/test_torch_ecapa_card.py -q

(``--noconftest``: the suite's ``conftest.py`` imports JAX, which these tests
do not need.) Without a card every test skips.

- B8 (``conv_blockn``) against its plain version at pool 1, as
  ``chip_smoke.check_blockn`` holds config #1's and #3's blocks: the f32
  output within ``chip_smoke.blockn_bound`` (u = 2^-24 times 4·K·|mul|·Σ|x·w|
  for the products' summation order, plus 4 ulps of the epilogue's three
  operations), the bf16 output by a row cosine of at least 0.9999. The
  shapes: the 1×1 TDNNs as one row of B·T (1024 → 1024, 3072 → 3072, ASP's
  folded 3328 → 128 and the published 9216 → 128), layer 1 (k = 5, 80 →
  1024, padded to 128 by ``pack_taps``) and the Res2Net convs (k = 3, 128 →
  128 at dilations 2, 3 and 4, an odd half-reach of 3 among them), each at
  T = 298 a row.
- The fast embed at the published widths, bf16, against
  ``portbench/reference/ecapa_tdnn.embed`` in f32 with TF32 off, on 128
  seeded utterances: within the benchmark cell's limits
  (``portbench/workloads/ecapa_tdnn.embed_bulk_16k.json``).
- A batch launches B6 once and B8 30 times, and no cuDNN or other library
  convolution: the profiler's kernels.
- The reference's weights are the same, bit for bit, from two calls.
"""

import json
import re
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from portbench import data
from portbench.kinds import embed_ecapa
from portbench.reference import ecapa_tdnn as ref
from voicemap_tpu_torch.models import ecapa
from voicemap_tpu_torch.ops.cuda_conv import conv_blockn
from voicemap_tpu_torch.ops.cuda_melspec import log_mel

REPO = Path(__file__).resolve().parent.parent
CONFIG = json.loads((REPO / "portbench/configs/ecapa_tdnn.json").read_text())
LIMITS = json.loads((REPO / "portbench/workloads/ecapa_tdnn.embed_bulk_16k.json").read_text())[
    "limits"]
SEED = 2**31 + 29
T = 298
# (B, T, Cin, Cout, k, dilation): 1×1 TDNNs as one row of B·T rows
SHAPES = [(1, 16 * T, 1024, 1024, 1, 1), (1, 16 * T, 3072, 3072, 1, 1),
          (1, 16 * T, 3328, 128, 1, 1), (1, 16 * T, 9216, 128, 1, 1),
          (16, T, 80, 1024, 5, 1), (64, T, 128, 128, 3, 2), (64, T, 128, 128, 3, 3),
          (64, T, 128, 128, 3, 4), (1, T, 128, 128, 3, 3)]
# Library convolutions a profiled batch must not launch (cuDNN's and
# cutlass's implicit GEMMs, PyTorch's own conv kernels).
LIBRARY_CONV = re.compile(r"(cudnn|implicit_gemm|fprop|xmma_conv|conv2d|convolve|"
                          r"conv_depthwise|slow_conv)", re.I)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B6 and B8 run only on the card")


def params(cin: int, cout: int, k: int, gen: torch.Generator) -> tuple:
    """A TDNN's weights in flax's layout and BatchNorm tensors, He-normal,
    running statistics near a relu's, some scales negative."""
    dev = "cuda"
    w = torch.randn(k, cin, cout, generator=gen, device=dev) * (2.0 / (k * cin)) ** 0.5
    vec = lambda lo, hi: lo + (hi - lo) * torch.rand(cout, generator=gen, device=dev)  # noqa: E731
    return (w, 0.1 * torch.randn(cout, generator=gen, device=dev), vec(-1.25, 1.25),
            0.1 * torch.randn(cout, generator=gen, device=dev), vec(0.3, 0.7), vec(0.2, 0.5))


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_b8_at_ecapa_shapes(card, shape):
    B, t, cin, cout, k, d = shape
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn(B, t, cin, generator=gen, device="cuda").to(torch.bfloat16)
    out = cs.check_blockn(x, params(cin, cout, k, gen), pool=1, dilation=d)
    assert out["err_over_bound"] <= 1.0 and out["bf16_min_row_cosine"] >= cs.B8_BF16_MIN_COSINE


@pytest.fixture(scope="module")
def model_and_rows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B6 and B8 run only on the card")
    cfg = embed_ecapa.experiment_config(CONFIG)
    model = embed_ecapa.model(cfg, CONFIG, 251, SEED, "cuda")
    spec = data.StoreSpec(32, 32, 3.0, 3.0)
    raw, _ = data.query_pool(spec, SEED, 128, 3.0, "cuda")
    return model, raw


@pytest.mark.card
def test_fast_embed_against_the_reference_at_published_widths(card, model_and_rows):
    model, raw = model_and_rows
    got = ecapa.fast_embed(model.encoder, (raw.float() / 32768.0)[..., None]).cpu()
    ref.strict_f32()
    want = ref.embed(ref.weights(CONFIG, SEED, "cuda"), ref.preprocess(raw, CONFIG), CONFIG).cpu()
    err = ref.relative_errors(got, want)
    assert float(err.max()) <= LIMITS["embed_err_max"], float(err.max())
    assert float(err.mean()) <= LIMITS["embed_err_mean"], float(err.mean())


@pytest.mark.card
def test_a_batch_launches_b6_once_b8_30_times_and_no_library_conv(card, model_and_rows):
    model, raw = model_and_rows
    x = (raw.float() / 32768.0)[..., None]
    ecapa.fast_embed(model.encoder, x)  # built and warm
    torch.cuda.synchronize()
    b6, b8 = log_mel.launches, conv_blockn.launches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ecapa.fast_embed(model.encoder, x)
        torch.cuda.synchronize()
    assert (log_mel.launches - b6, conv_blockn.launches - b8) == (1, 30)
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("log_mel_tc_kernel" in n for n in kernels) == 1
    assert sum("conv_blockn_kernel" in n for n in kernels) == 30
    assert not [n for n in kernels if LIBRARY_CONV.search(n) and "conv_blockn" not in n]


@pytest.mark.card
def test_reference_weights_repeat_bit_for_bit(card):
    a, b = ref.weights(CONFIG, SEED, "cuda"), ref.weights(CONFIG, SEED, "cuda")
    assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
