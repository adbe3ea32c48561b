"""The port's preprocessing against the JAX package's, on the CPU.

Covers ``ops/preprocess.py``, the B1 plain version (``gather_whiten_reference``)
against the Pallas kernel run in interpret mode, and ``fetch_batch`` against
the JAX package's. Inputs are made with numpy from a seed; each test states
its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicemap_tpu.ops import preprocess as jpre
from voicemap_tpu.ops.pallas_preprocess import decimate_store as j_decimate_store
from voicemap_tpu.ops.pallas_preprocess import pallas_gather_whiten
from voicemap_tpu_torch.config import DataConfig, ExperimentConfig
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.ops import preprocess as tpre
from voicemap_tpu_torch.ops.cuda_preprocess import (
    decimate_store, gather_whiten, gather_whiten_reference,
)
from voicemap_tpu_torch.train.steps import device_store_for, fetch_batch
from test_torch_config import jax_config

# Same f32 arithmetic, other reduction order.
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("shape", [(5, 256), (5, 256, 1)])
def test_whiten_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 0.3 + 0.1
    got = tpre.whiten(torch.from_numpy(x)).numpy()
    want = np.asarray(jpre.whiten(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ds", [1, 2, 4])
def test_stride_decimate_matches_jax(ds):
    x = np.random.default_rng(1).standard_normal((5, 257)).astype(np.float32)
    got = tpre.stride_decimate(torch.from_numpy(x), ds).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpre.stride_decimate(jnp.asarray(x), ds)))


def test_gather_fragments_matches_jax():
    rng = np.random.default_rng(2)
    store = rng.integers(-30000, 30000, (7, 900), dtype=np.int16)
    idx = rng.integers(0, 7, 5).astype(np.int32)
    off = np.array([0, 1, 399, 250, 17], np.int32)  # 399 = last valid for 500
    got = tpre.gather_fragments(torch.from_numpy(store), torch.from_numpy(idx),
                                torch.from_numpy(off), 500).numpy()
    want = np.asarray(jpre.gather_fragments(jnp.asarray(store), jnp.asarray(idx),
                                            jnp.asarray(off), 500))
    np.testing.assert_array_equal(got, want)


def test_decimate_store_is_the_unpadded_jax_store():
    store = np.random.default_rng(3).integers(-30000, 30000, (3, 1001), dtype=np.int16)
    got = decimate_store(torch.from_numpy(store), 4).numpy()
    want = np.asarray(j_decimate_store(jnp.asarray(store), 4))
    assert got.shape == (3, 251)
    np.testing.assert_array_equal(got, want[:, :251])
    assert not want[:, 251:].any()  # the JAX guard pad is zeros


@pytest.mark.parametrize("rms", [jpre.DEFAULT_WHITEN_RMS, None])
def test_b1_plain_matches_pallas_interpret(rms):
    """B1's plain version against the TPU kernel's own code over a decimated
    store: B=5, sample-granular offsets including 0, the last valid start
    and one that runs 40 samples past the row (zeros, like the JAX pad)."""
    rng = np.random.default_rng(4)
    raw = rng.integers(-30000, 30000, (6, 4000), dtype=np.int16)
    frag = 640
    ds_t = decimate_store(torch.from_numpy(raw), 4)
    last = ds_t.shape[1] - frag  # 360
    off = np.array([0, last, rng.integers(1, last), last + 40, 7], np.int32)
    idx = rng.integers(0, 6, 5).astype(np.int32)
    got = gather_whiten_reference(ds_t, torch.from_numpy(idx), torch.from_numpy(off),
                                  frag, whiten_rms=rms).numpy()
    want = np.asarray(pallas_gather_whiten(
        j_decimate_store(jnp.asarray(raw), 4), jnp.asarray(idx), jnp.asarray(off),
        frag, whiten_rms=rms, interpret=True))
    assert got.shape == (5, frag)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_b1_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    store = torch.from_numpy(rng.integers(-30000, 30000, (4, 300), dtype=np.int16))
    idx = torch.tensor([3, 0, 1, 2, 3], dtype=torch.int32)
    off = torch.tensor([0, 44, 100, 300, 5], dtype=torch.int32)
    before = gather_whiten.launches
    got = gather_whiten(store, idx, off, 200)
    assert gather_whiten.launches == before  # the CPU path launches nothing
    torch.testing.assert_close(got, gather_whiten_reference(store, idx, off, 200),
                               rtol=0, atol=0)
    # offset 300 starts at the row's end: silence, whitened to zeros
    assert not got[3].any()
    with pytest.raises(ValueError):
        gather_whiten(store.to("meta"), idx.to("meta"), off.to("meta"), 200)


def test_sample_offsets_range_and_determinism():
    lengths = torch.tensor([1000, 1200, 999, 5000, 1000], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    off = tpre.sample_offsets(lengths, 1000, g)
    assert off.dtype == torch.int32
    assert (off >= 0).all() and (off <= (lengths - 1000).clamp(min=0)).all()
    assert off[2] == 0 and off[0] == 0  # no room: start at 0
    again = tpre.sample_offsets(lengths, 1000, torch.Generator().manual_seed(0))
    torch.testing.assert_close(off, again, rtol=0, atol=0)
    assert not tpre.sample_offsets(lengths, 1000, g, stochastic=False).any()


def _jax_store(store):
    from voicemap_tpu.data.dataset import AudioStore as JaxAudioStore

    return JaxAudioStore(**dataclasses.asdict(store))


def test_fetch_batch_matches_jax_raw_store_at_offset_zero():
    """Offset 0: the port's once-decimated store and the JAX package's raw
    gather → decimate → whiten chain pick the same samples (ROADMAP trap C:
    at random raw offsets the decimation phases differ)."""
    from voicemap_tpu.train import steps as jsteps

    cfg = ExperimentConfig(data=DataConfig(seconds=0.25, downsampling=4))
    host = synthetic_store(6, n_speakers=3, utterances_per_speaker=2,
                           min_seconds=0.2, max_seconds=0.5)
    idx = np.array([5, 0, 3, 1, 2], np.int32)
    jstore = jsteps.DeviceStore.from_host(_jax_store(host), pallas_downsampling=0,
                                          min_length=cfg.data.fragment_length)
    want = np.asarray(jsteps.fetch_batch(jstore, jnp.asarray(idx),
                                         jax.random.PRNGKey(0), jax_config(cfg),
                                         stochastic=False))
    store = device_store_for(cfg, host, "cpu")
    got = fetch_batch(store, torch.from_numpy(idx), cfg, stochastic=False).numpy()
    assert got.shape == (5, cfg.data.model_length, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
