"""The train forward (``models/fused_train.py``) against flax's train apply.

``classifier_train_forward`` under each policy (autograd blocks, the B4/B5
block-0 op, and the B7 blocks-1+ op) and the module's own train-mode
forward, against ``SpeakerClassifier.apply(train=True,
mutable=["batch_stats"])`` at f32 with dropout 0: logits, the parameter
gradients of the softmax cross-entropy, and the running statistics the
forward leaves in the module's buffers, within 1e-4. On the CPU the kernels'
plain versions stand in for B4, B5 and B7. Dropout is checked for its
structure: whole channels, zeroed or scaled by 1/keep.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_config import jax_config
from test_torch_encoder import randomize_bn
from voicemap_tpu.models.classifier import SpeakerClassifier as JaxClassifier
from voicemap_tpu_torch.config import EncoderConfig
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax, to_flax
from voicemap_tpu_torch.models.encoder import ConvBlock, spatial_dropout
from voicemap_tpu_torch.models.fused_train import classifier_train_forward
from voicemap_tpu_torch.train.losses import softmax_ce

CFG = EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, compute_dtype="float32")
B, CLASSES = 4, 5
TOL = 1e-4


def setup(T, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, 1)) * 0.5).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    jmodel = JaxClassifier(jax_config(CFG), num_classes=CLASSES)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    return x, y, jmodel, variables


def jax_side(jmodel, variables, x, y):
    def loss(params):
        logits, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(x), train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return ce, (logits, mut["batch_stats"])

    (ce, (logits, stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return float(ce), np.asarray(logits), grads, stats


def assert_tree_close(got, want, tol, path=""):
    if isinstance(want, dict) or hasattr(want, "items"):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=path)


@pytest.mark.parametrize("fused_block0,blockn", [("module", None), (False, "jnp"),
                                                 (True, "jnp"), (True, "fused")])
@pytest.mark.parametrize("T", [256, 260])
def test_train_forward_matches_flax(fused_block0, blockn, T):
    """T=260: block 0's T divides 4 but block 1's 65 does not divide 2, so
    the fused blocks-1+ policy falls back to the plain block there."""
    x, y, jmodel, variables = setup(T, 3)
    ce, logits, grads, stats = jax_side(jmodel, variables, x, y)
    model = SpeakerClassifier(CFG, CLASSES, device="cpu")
    model.load_state_dict(from_flax(variables, CFG))
    model.train()
    xt = torch.from_numpy(x)
    if fused_block0 == "module":
        out = model(xt)
    else:
        out = classifier_train_forward(model, xt, None, blockn, fused_block0)
    loss = softmax_ce(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ce, rtol=TOL)
    np.testing.assert_allclose(out.detach().numpy(), logits, rtol=TOL, atol=TOL)
    got = to_flax({n: p.grad for n, p in model.named_parameters()}, CFG)
    assert_tree_close(got["params"], grads, TOL)
    assert_tree_close(to_flax(model.state_dict(), CFG)["batch_stats"], stats, TOL)


def test_to_flax_inverts_from_flax():
    _, _, _, variables = setup(64, 5)
    back = to_flax(from_flax(variables, CFG), CFG)
    assert_tree_close(back, variables, 0.0)


def test_spatial_dropout_drops_whole_channels():
    keep = 0.5
    y = torch.rand(6, 7, 20) + 0.5  # (B, C, T), no zeros of its own
    gen = torch.Generator().manual_seed(0)
    out = spatial_dropout(y, 1.0 - keep, gen)
    kept = out != 0
    assert bool((kept.all(-1) | (~kept).all(-1)).all())  # per (row, channel), over all time
    torch.testing.assert_close(out[kept], y[kept] / keep)
    assert 0 < int(kept[..., 0].sum()) < 42
    out_t = spatial_dropout(y.transpose(1, 2), 1.0 - keep, torch.Generator().manual_seed(0),
                            channel_dim=2)
    torch.testing.assert_close(out_t.transpose(1, 2), out)  # same draw in either layout
    with pytest.raises(ValueError):
        spatial_dropout(y, 0.5, None)


def test_train_block_dropout_is_pooled_channel_scaling():
    """ConvBlock in train mode with dropout: every (row, channel) of the
    output is 0 or the dropout-free output over keep (the max-pool commutes
    with a non-negative channel scale); same generator seed, same masks."""
    torch.manual_seed(0)
    blk = ConvBlock(3, 10, 3, 2, compute_dtype=torch.float32, device="cpu", dropout=0.4).train()
    x = torch.randn(5, 3, 40)
    ref = ConvBlock(3, 10, 3, 2, compute_dtype=torch.float32, device="cpu").train()
    ref.load_state_dict(blk.state_dict())
    base = ref.forward_train_nct(x)
    drop = blk.forward_train_nct(x, torch.Generator().manual_seed(1))
    again = blk.forward_train_nct(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(drop, again, rtol=0, atol=0)
    zero = (drop == 0).all(-1)
    torch.testing.assert_close(drop[~zero], base[~zero] / 0.6)
    assert 0 < int(zero.sum()) < 50
    with pytest.raises(ValueError):
        blk.forward_train_nct(x)


def test_fused_forward_needs_a_generator_with_dropout():
    cfg = dataclasses.replace(CFG, dropout=0.1)
    model = SpeakerClassifier(cfg, CLASSES, device="cpu").train()
    x = torch.randn(2, 256, 1)
    with pytest.raises(ValueError):
        classifier_train_forward(model, x, None, "fused", True)
    a = classifier_train_forward(model, x, torch.Generator().manual_seed(2), "fused", True)
    b = classifier_train_forward(model, x, torch.Generator().manual_seed(3), "fused", True)
    assert a.shape == (2, CLASSES) and not torch.equal(a, b)
    with pytest.raises(ValueError):
        classifier_train_forward(model, x, None, "fused_recompute", True)
