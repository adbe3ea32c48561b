"""The corpus on the device, and batch fetch.

Port of the store half of ``voicemap_tpu/train/steps.py`` (``DeviceStore``,
``device_store_for``, ``fetch_batch``); the train steps come with the
training port.

The port has one preprocessing path, the fused one: the store is decimated
once when it is shipped, and every batch goes through the B1 gather+whiten
(``ops/cuda_preprocess``). Lengths and offsets are in decimated units, as on
the JAX package's Pallas path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import ExperimentConfig
from ..data.store import AudioStore
from ..ops import preprocess
from ..ops.cuda_preprocess import decimate_store, gather_whiten


@dataclass
class DeviceStore:
    """An :class:`AudioStore` on a device, decimated by ``downsampling``."""

    audio: torch.Tensor  # (N, ceil(T_store / ds)) int16
    lengths: torch.Tensor  # (N,) int32, decimated units
    labels: torch.Tensor  # (N,) int32
    speaker_utts: torch.Tensor  # (S, max_utt) int32
    speaker_counts: torch.Tensor  # (S,) int32
    downsampling: int

    @classmethod
    def from_host(cls, store: AudioStore, device, downsampling: int,
                  min_length: int = 0) -> "DeviceStore":
        """Ship the corpus to ``device`` and decimate it there, once.

        ``min_length`` zero-pads rows to at least this many raw samples.
        """
        audio = torch.from_numpy(store.audio).to(device)
        if audio.shape[1] < min_length:
            audio = F.pad(audio, (0, min_length - audio.shape[1]))
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return cls(
            audio=decimate_store(audio, downsampling),
            lengths=put(store.lengths) // downsampling,
            labels=put(store.labels),
            speaker_utts=put(store.speaker_utts),
            speaker_counts=put(store.speaker_counts),
            downsampling=int(downsampling),
        )


def device_store_for(cfg: ExperimentConfig, audio_store: AudioStore,
                     device) -> DeviceStore:
    """The :class:`DeviceStore` that ``fetch_batch`` needs for this config."""
    return DeviceStore.from_host(audio_store, device, cfg.data.downsampling,
                                 min_length=cfg.data.fragment_length)


def fetch_batch(store: DeviceStore, indices: torch.Tensor, cfg: ExperimentConfig,
                generator: Optional[torch.Generator] = None,
                stochastic: bool = True) -> torch.Tensor:
    """Utterance ids ``(B,)`` → preprocessed model inputs ``(B, T_model, 1)`` f32."""
    d = cfg.data
    if store.downsampling != d.downsampling:
        raise ValueError(
            f"store decimated by {store.downsampling} but config expects "
            f"downsampling {d.downsampling}")
    t_out = d.model_length
    indices = indices.to(device=store.audio.device, dtype=torch.int32).contiguous()
    offsets = preprocess.sample_offsets(store.lengths[indices.long()], t_out,
                                        generator, stochastic)
    out = gather_whiten(store.audio, indices, offsets.contiguous(), t_out,
                        d.whiten_rms, d.whiten_eps)
    return out[..., None]
