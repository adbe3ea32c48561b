"""The dilated convs' weight gradient on the card (``ops/cuda_wgrad.conv_wgrad``,
``csrc/conv_wgrad.cu``) against float64 sums. Run on a machine with a card,
from the repository root:

    python -m pytest --noconftest -m card tests/test_torch_conv_wgrad_card.py -q

(``--noconftest``: the suite's ``conftest.py`` imports JAX, which these tests
do not need.) Without a card every test skips.

- Config #3's four dilated blocks (T 3000, 1500, 750, 375; 128 to 512
  channels; d 2, 4, 8, 16) at 2048 rows (the training cell's batch; the
  float64 sums are added over 256-row chunks), 256, 32 and one, and ragged
  shapes (T 1001 and 7, a reach of 32 over T = 20, Cin 72 and 136, Cout 40
  and 200, d 3): each dW element within ``REL_TOL`` of the largest |element| of the
  float64 sums of the same bf16 inputs (every product is exact in f32; the
  tensor cores' f32 sums truncate, and the kernel adds them into its slots
  every 16384 rows, which keeps them near 2e-5 of the largest at any batch;
  without that, 2048 rows read 1.0e-4 to 1.3e-4 at blocks 3, 5 and 7); the
  plain version is held to the same bound.
- Two calls agree bit for bit (the splits are added in a fixed order).
- The wrapper's refusals on the card, and its launch counter.
- The fused op's backward at d = 4 in a bf16 GEMM: one launch, and dW
  within ``REL_TOL`` of the same backward with the plain version; at d = 65
  and at 12 input channels, outside the kernel's domain, no launch and
  cuDNN's dW.
"""

import pytest
import torch

from voicemap_tpu_torch.ops import cuda_wgrad
from voicemap_tpu_torch.ops.conv_train import FusedBlocknTrain
from voicemap_tpu_torch.ops.cuda_wgrad import conv_wgrad, conv_wgrad_reference

REL_TOL = 1e-4
# (B, T, Cin, Cout, dilation)
BLOCKS = [(256, 3000, 128, 128, 2), (256, 1500, 256, 256, 4), (256, 750, 384, 384, 8),
          (256, 375, 512, 512, 16)]
CHUNK = 256  # rows of each float64 sum
SHAPES = (BLOCKS + [(rows, T, cin, cout, d) for rows in (1, 32, 2048)
                    for _, T, cin, cout, d in BLOCKS]
          + [(3, 1001, 72, 40, 16), (2, 20, 64, 64, 16), (1, 7, 8, 24, 2),
             (5, 300, 136, 200, 3)])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def inputs(seed, B, T, cin, cout):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, T, cin, generator=gen, device="cuda").to(torch.bfloat16),
            torch.randn(B, T, cout, generator=gen, device="cuda").to(torch.bfloat16))


def rel_err(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_against_float64_sums(card, shape):
    B, T, cin, cout, d = shape
    x, dz = inputs(sum(shape), B, T, cin, cout)
    before = conv_wgrad.launches
    got = conv_wgrad(x, dz, 3, d)
    again = conv_wgrad(x, dz, 3, d)
    torch.cuda.synchronize()
    assert conv_wgrad.launches == before + 2
    assert got.shape == (cout, cin, 3) and got.dtype == torch.float32
    want = sum(conv_wgrad_reference(x[lo:lo + CHUNK].double(), dz[lo:lo + CHUNK].double(), 3, d)
               for lo in range(0, B, CHUNK))
    assert rel_err(got, want) <= REL_TOL
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    plain = sum(conv_wgrad_reference(x[lo:lo + CHUNK], dz[lo:lo + CHUNK], 3, d)
                for lo in range(0, B, CHUNK))
    assert rel_err(plain, want) <= REL_TOL


@pytest.mark.card
@pytest.mark.parametrize("case", ["float32", "transposed", "k5", "cin_12", "dilation_65",
                                  "misaligned"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(card, case):
    x, dz = inputs(1, 2, 64, 16, 16)
    args = {"float32": (x.float(), dz.float(), 3, 2),
            "transposed": (x.transpose(0, 1), dz.transpose(0, 1), 3, 2),
            "k5": (x, dz, 5, 2),
            "cin_12": (x[..., :12], dz, 3, 2),
            "dilation_65": (x, dz, 3, 65),
            "misaligned": (x.flatten()[1:1 + 2 * 63 * 16].view(2, 63, 16),
                           dz[:, 1:].contiguous(), 3, 2)}[case]
    before = conv_wgrad.launches
    with pytest.raises(ValueError):
        conv_wgrad(*args)
    assert conv_wgrad.launches == before


@pytest.mark.card
def test_the_fused_backward_takes_the_kernel_at_d4_in_bf16(card, monkeypatch):
    B, cin, cout, T = 8, 256, 256, 1500
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(B, T, cin, generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1)
    w = torch.randn(cout, cin, 3, generator=gen, device="cuda") * 0.05
    b = torch.randn(cout, generator=gen, device="cuda") * 0.1
    gamma = torch.rand(cout, generator=gen, device="cuda") + 0.5
    beta = torch.zeros(cout, device="cuda")
    gy = torch.randn(B, cout, T, generator=gen, device="cuda")

    def dw():
        wl = w.clone().requires_grad_()
        y, _, _ = FusedBlocknTrain.apply(x, wl, b, gamma, beta, 1, 1e-3, 4, torch.bfloat16,
                                         "none", torch.bfloat16, None, 1.0, 3)
        (g,) = torch.autograd.grad((y.float() * gy).sum(), [wl])
        return g

    before = conv_wgrad.launches
    got = dw()
    torch.cuda.synchronize()
    assert conv_wgrad.launches == before + 1
    monkeypatch.setattr(cuda_wgrad, "conv_wgrad", conv_wgrad_reference)
    want = dw()
    assert rel_err(got, want.double()) <= REL_TOL


@pytest.mark.card
@pytest.mark.parametrize("cin,dilation", [(16, 65), (12, 4)], ids=["d65", "cin12"])
def test_the_fused_backward_leaves_what_the_kernel_does_not_take_to_cudnn(card, cin, dilation):
    B, cout, T = 4, 16, 300
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(B, T, cin, generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1)
    w = (torch.randn(cout, cin, 3, generator=gen, device="cuda") * 0.05).requires_grad_()
    b = torch.randn(cout, generator=gen, device="cuda") * 0.1
    gamma = torch.rand(cout, generator=gen, device="cuda") + 0.5
    beta = torch.zeros(cout, device="cuda")
    before = conv_wgrad.launches
    y, _, _ = FusedBlocknTrain.apply(x, w, b, gamma, beta, 1, 1e-3, dilation, torch.bfloat16,
                                     "none", torch.bfloat16, None, 1.0, 1)
    (g,) = torch.autograd.grad(y.float().square().sum(), [w])
    torch.cuda.synchronize()
    assert conv_wgrad.launches == before
    assert g.shape == (cout, cin, 3) and bool(torch.isfinite(g).all())
