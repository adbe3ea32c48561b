"""The port's copy of the configs against the JAX package's, and the
models' default device.

``voicemap_tpu_torch/config.py`` is a copy, so that the port imports nothing
of the JAX package. These tests hold the copy to the original: every preset
field by field, the constants, frozenness and hashing (the JAX package's
jitted functions take configs as static arguments). The models are built on
the card unless the caller asks for the CPU.

``jax_config`` is also the port tests' way to hand the JAX package a config
with the same values as a port config.
"""

import dataclasses

import pytest
import torch

import voicemap_tpu.config as jconfig
import voicemap_tpu_torch.config as tconfig
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.encoder import ConvEncoder


def jax_config(cfg):
    """The JAX package's config object with the same values as the port's ``cfg``."""
    cls = getattr(jconfig, type(cfg).__name__)
    values = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        values[f.name] = jax_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**values)


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_equal_the_jax_packages(name):
    got, want = tconfig.PRESETS[name](), jconfig.PRESETS[name]()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.artifact_name() == want.artifact_name()
    assert got.data.model_length == want.data.model_length
    assert jax_config(got) == want
    assert hash(got) == hash(tconfig.PRESETS[name]())  # static-argument hashing


def test_constants_and_class_fields_equal_the_jax_packages():
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name in ("LIBRISPEECH_SAMPLING_RATE", "DEFAULT_WHITEN_RMS", "PATH", "DATA_PATH"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    for cls in ("DataConfig", "EncoderConfig", "MelConfig", "SiameseConfig",
                "TrainConfig", "ExperimentConfig"):
        t, j = getattr(tconfig, cls), getattr(jconfig, cls)
        assert [(f.name, f.type) for f in dataclasses.fields(t)] == \
               [(f.name, f.type) for f in dataclasses.fields(j)], cls
        assert dataclasses.asdict(t()) == dataclasses.asdict(j()), cls
        assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen


def test_configs_are_frozen_and_replace_works():
    cfg = tconfig.classifier_baseline(name="x")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.mode = "siamese"
    assert cfg.replace(mode="siamese").mode == "siamese" and cfg.name == "x"


def test_models_are_built_on_the_card_unless_asked():
    """``ConvEncoder`` and ``SpeakerClassifier`` default to ``device="cuda"``.
    Where PyTorch has no card, building there raises (``AssertionError: Torch
    not compiled with CUDA enabled`` on a CPU-only build); a CPU model is only
    one asked for."""
    cfg = tconfig.EncoderConfig(filters=8, embedding_dim=16)
    if torch.cuda.is_available():
        assert next(ConvEncoder(cfg).parameters()).is_cuda
        assert next(SpeakerClassifier(cfg, 3).parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ConvEncoder(cfg)
        with pytest.raises((AssertionError, RuntimeError)):
            SpeakerClassifier(cfg, 3)
    assert not next(ConvEncoder(cfg, device="cpu").parameters()).is_cuda
