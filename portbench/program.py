"""The program under test, ``voicemap_tpu_torch``, as the benchmark drives it:
its config from a config file, a store on the device from the benchmark's
raw rows, a classifier holding the benchmark's weights.

With the kinds (``kinds/``) and ``faults.py``, the modules of the benchmark
that import the program; the plain reference never does.
"""

from __future__ import annotations

import dataclasses

import torch

from voicemap_tpu_torch import config as vm_config
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.ops.cuda_preprocess import decimate_store
from voicemap_tpu_torch.train.steps import DeviceStore

from . import data


def _group(dc, doc: dict):
    """A config dataclass with the file's values, lists as tuples."""
    return dataclasses.replace(dc, **{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in doc.items()})


def experiment_config(config: dict, **train) -> vm_config.ExperimentConfig:
    """The preset the file names, with the file's encoder, data and train
    values, and ``train`` on top (the traffic's batch size)."""
    cfg = vm_config.PRESETS[config["preset"]]()
    return cfg.replace(encoder=_group(cfg.encoder, config["encoder"]),
                       data=_group(cfg.data, config["data"]),
                       train=_group(cfg.train, {**config.get("train", {}), **train}))


def device_store(spec: data.StoreSpec, seed: int, downsampling: int, device) -> DeviceStore:
    """The store on ``device``, decimated once by the program's
    ``decimate_store`` chunk by chunk from the benchmark's raw rows, as
    ``DeviceStore.from_host`` prepares B1's store."""
    width = -(-spec.row_samples // downsampling)
    audio = torch.empty((spec.utterances, width), dtype=torch.int16, device=device)
    for c in range(data.n_chunks(spec)):
        raw = data.raw_chunk(spec, seed, c, device)
        audio[c * data.CHUNK:c * data.CHUNK + raw.shape[0]] = decimate_store(raw, downsampling)
        del raw
    counts = data.speaker_counts(spec)
    utts = torch.zeros((spec.speakers, int(counts.max())), dtype=torch.int32)
    start = 0
    for s, n in enumerate(counts.tolist()):
        utts[s, :n] = torch.arange(start, start + n, dtype=torch.int32)
        start += n
    put = lambda t: t.to(device=device, dtype=torch.int32)  # noqa: E731
    return DeviceStore(audio=audio, lengths=put(data.lengths(spec, seed) // downsampling),
                       labels=put(data.labels(spec)), speaker_utts=put(utts),
                       speaker_counts=put(counts), downsampling=downsampling)


# The port's parameter and buffer of each neutral weight name's part.
_BLOCK_PARTS = {"w": "conv.weight", "b": "conv.bias", "gamma": "bn.weight", "beta": "bn.bias",
                "mean": "bn.running_mean", "var": "bn.running_var"}


def port_name(name: str) -> str:
    """``blocks.<i>.<part>`` → the port's state-dict key, and so on."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return f"encoder.blocks.{parts[1]}.{_BLOCK_PARTS[parts[2]]}"
    return {"embed": "encoder.embed", "head": "head"}[parts[0]] + {"w": ".weight",
                                                                   "b": ".bias"}[parts[1]]


def classifier(cfg, config: dict, num_classes: int, seed: int, device) -> SpeakerClassifier:
    """The port's classifier, holding the benchmark's weights for ``seed``."""
    model = SpeakerClassifier(cfg.encoder, num_classes, device=device)
    state = model.state_dict()
    made = {port_name(n): t for n, t in data.weights(config, num_classes, seed, device).items()}
    missing = {k for k, t in state.items() if t.is_floating_point()} - set(made)
    if missing or set(made) - set(state):
        raise ValueError(f"made weights do not match the model: {sorted(missing)}")
    state.update(made)
    model.load_state_dict(state, strict=True)
    return model


def leaves(model: SpeakerClassifier) -> dict:
    """The model's parameters by neutral name."""
    by_port = dict(model.named_parameters())
    out = {}
    for i in range(len(model.encoder.blocks)):
        for part in ("w", "b", "gamma", "beta"):
            out[f"blocks.{i}.{part}"] = by_port[port_name(f"blocks.{i}.{part}")]
    for name in ("embed.w", "embed.b", "head.w", "head.b"):
        out[name] = by_port[port_name(name)]
    return out
