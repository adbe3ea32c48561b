"""Host-side (numpy) preprocessing: whitening, decimation, labels.

Port of ``voicemap_tpu/data/preprocessing.py``, for scripts that work on
host batches (``SpeakerDataset.build_*_batch``). The training and serving
paths do the same arithmetic on the device (``ops/preprocess.py``, the B1
kernel, ``train/steps.preprocess_fragments``).

- ``whiten(batch, rms)``: per-fragment zero mean, then a fixed RMS;
- ``preprocess_instances(downsampling, whitening)``: stride decimation
  (no anti-alias filter), then whitening;
- ``label_preprocessor(num_classes, mapping)``: speaker ids → one-hot;
- ``BatchPreProcessor(mode, …)``: both, on a siamese or classifier batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..config import DEFAULT_WHITEN_RMS


def whiten(batch: np.ndarray, rms: float = DEFAULT_WHITEN_RMS,
           eps: float = 1e-8) -> np.ndarray:
    """Per-fragment zero-mean, fixed-RMS rescale of (B, T) or (B, T, 1),
    over the time axis."""
    if batch.ndim not in (2, 3):
        raise ValueError(f"whiten expects (B, T) or (B, T, 1), got {batch.shape}")
    x = batch.astype(np.float32)
    mean = x.mean(axis=1, keepdims=True)
    centered = x - mean
    cur = np.sqrt((centered**2).mean(axis=1, keepdims=True))
    return centered * (rms / (cur + eps))


def preprocess_instances(
    downsampling: int, whitening: bool = True, rms: float = DEFAULT_WHITEN_RMS
) -> Callable[[np.ndarray], np.ndarray]:
    """Closure: stride decimation ``instances[:, ::downsampling]`` with no
    anti-alias filter, then (optionally) whitening."""

    def fn(instances: np.ndarray) -> np.ndarray:
        x = instances[:, ::downsampling]
        if whitening:
            x = whiten(x, rms)
        return x

    return fn


def label_preprocessor(
    num_classes: int, speaker_id_mapping: Dict[int, int]
) -> Callable[[np.ndarray], np.ndarray]:
    """Raw speaker ids → contiguous indices → one-hot (B, num_classes)."""

    def fn(labels: np.ndarray) -> np.ndarray:
        idx = np.asarray([speaker_id_mapping[int(l)] for l in np.ravel(labels)])
        out = np.zeros((len(idx), num_classes), dtype=np.float32)
        out[np.arange(len(idx)), idx] = 1.0
        return out

    return fn


class BatchPreProcessor:
    """Instance and target preprocessing of host batches: ``mode``
    ``"siamese"`` takes ``([input_1, input_2], labels)``, ``"classifier"``
    takes ``(instances, labels)``."""

    def __init__(
        self,
        mode: str,
        instance_preprocessor: Callable[[np.ndarray], np.ndarray],
        target_preprocessor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        if mode not in ("siamese", "classifier"):
            raise ValueError("mode must be 'siamese' or 'classifier'")
        self.mode = mode
        self.instance_preprocessor = instance_preprocessor
        self.target_preprocessor = target_preprocessor or (lambda y: y)

    def __call__(self, batch: Tuple) -> Tuple:
        inputs, targets = batch
        if self.mode == "siamese":
            x1, x2 = inputs
            inputs = [
                self.instance_preprocessor(x1),
                self.instance_preprocessor(x2),
            ]
        else:
            inputs = self.instance_preprocessor(inputs)
        return inputs, self.target_preprocessor(np.asarray(targets))
