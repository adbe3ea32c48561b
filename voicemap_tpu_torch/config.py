"""Configuration: frozen dataclass configs and the presets of every config.

A copy of ``voicemap_tpu/config.py``, so that the port stands without the JAX
package: the same dataclasses with the same fields, defaults and frozenness,
the same constants and the same four presets. ``tests/test_torch_config.py``
holds every preset equal, field by field, to the JAX package's, so a change
on either side that is not made on the other fails there.

The port's own configurations, which the JAX package does not have, sit
apart from that copy: ``EcapaConfig``, ``EcapaExperimentConfig`` and the
``ecapa_tdnn`` preset, in ``PORT_PRESETS`` beside ``PRESETS``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

LIBRISPEECH_SAMPLING_RATE = 16000

# The repository root; the data directory defaults to ``<root>/data`` and
# ``VOICEMAP_DATA`` overrides it.
PATH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_PATH = os.environ.get("VOICEMAP_DATA", os.path.join(PATH, "data"))

# Target RMS amplitude of a whitened fragment (≈ LibriSpeech's mean fragment RMS).
DEFAULT_WHITEN_RMS = 0.038021


@dataclass(frozen=True)
class DataConfig:
    """Dataset and on-device preprocessing parameters."""

    data_root: str = DATA_PATH
    subsets: Tuple[str, ...] = ("dev-clean",)
    # Validation subsets for n-shot eval; None evaluates on the training store.
    val_subsets: Optional[Tuple[str, ...]] = None
    seconds: float = 3.0
    sample_rate: int = LIBRISPEECH_SAMPLING_RATE
    downsampling: int = 4
    stochastic: bool = True
    pad: bool = False
    label: str = "speaker"  # or "sex"
    # Whitening: per-fragment zero mean, then this fixed RMS; None disables it.
    whiten_rms: Optional[float] = DEFAULT_WHITEN_RMS
    # Guards the RMS division for all-zero fragments.
    whiten_eps: float = 1e-8
    use_cache: bool = True

    @property
    def fragment_length(self) -> int:
        """Raw samples per fragment (before downsampling)."""
        return int(self.seconds * self.sample_rate)

    @property
    def model_length(self) -> int:
        """Samples per fragment as the model sees them (after downsampling)."""
        return self.fragment_length // self.downsampling


@dataclass(frozen=True)
class EncoderConfig:
    """1D-conv encoder topology: blocks × [Conv1D → relu → BatchNorm →
    SpatialDropout1D → MaxPool1D] → GlobalMaxPool1D → Dense(embedding_dim)."""

    filters: int = 128
    embedding_dim: int = 64
    dropout: float = 0.05
    filter_multipliers: Tuple[int, ...] = (1, 2, 3, 4)
    kernel_sizes: Tuple[int, ...] = (32, 3, 3, 3)
    pool_sizes: Tuple[int, ...] = (4, 2, 2, 2)
    # Dilation per block; all ones is the baseline encoder (config #3 dilates).
    dilations: Tuple[int, ...] = (1, 1, 1, 1)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Keras BatchNormalization defaults.
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3


@dataclass(frozen=True)
class SiameseConfig:
    """Siamese verification head. ``same_label`` = 0: a smaller output means
    "same speaker"."""

    distance_metric: str = "uniform_euclidean"
    # uniform_euclidean | weighted_l1 | uniform_l1 | dot_product | cosine_distance
    same_label: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (the port reads the evaluation ones)."""

    batch_size: int = 64
    learning_rate: float = 1e-3
    clipnorm: float = 1.0
    num_steps: int = 2000
    loss: str = "bce"  # bce | contrastive (siamese); always softmax-CE for classifier
    contrastive_margin: float = 1.0
    evaluate_every: int = 500
    num_eval_tasks: int = 500
    n_shot: int = 1
    k_way: int = 5
    seed: int = 0
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    min_lr: float = 1e-5
    # Kernel and forward-path switches of the JAX package's train step; None
    # means automatic there. Kept so that configs round-trip between packages.
    use_pallas_preprocess: Optional[bool] = None
    use_fused_block0: Optional[bool] = None
    use_fused_blockn: Optional[bool] = None
    quant_forward: str = "none"
    require_holdout_eval: bool = False
    checkpoint_dir: Optional[str] = None
    log_path: Optional[str] = None  # JSONL metrics


@dataclass(frozen=True)
class MelConfig:
    """Log-mel spectrogram frontend (config #4)."""

    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    n_mels: int = 64
    fmin: float = 0.0
    fmax: Optional[float] = None  # defaults to sr/2
    log_eps: float = 1e-6


@dataclass(frozen=True)
class ExperimentConfig:
    """One end-to-end experiment = data + model + training."""

    name: str = "classifier_baseline"
    mode: str = "classifier"  # classifier | siamese | melspec2d
    data: DataConfig = field(default_factory=DataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    siamese: SiameseConfig = field(default_factory=SiameseConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mel: MelConfig = field(default_factory=MelConfig)

    def artifact_name(self) -> str:
        """Hyperparameters-in-artifact-name convention."""
        e, d, t = self.encoder, self.data, self.train
        return (
            f"{self.mode}__filters_{e.filters}__embed_{e.embedding_dim}"
            f"__drop_{e.dropout}__seconds_{d.seconds}__down_{d.downsampling}"
            f"__batch_{t.batch_size}"
        )

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets, one per configuration of the repository
# ---------------------------------------------------------------------------

def classifier_baseline(**overrides) -> ExperimentConfig:
    """Config #1: 1D-conv speaker classifier, dev-clean, 3 s at 16 kHz, batch 32,
    validated on held-out test-clean."""
    cfg = ExperimentConfig(
        name="classifier_baseline",
        mode="classifier",
        data=DataConfig(subsets=("dev-clean",), seconds=3.0, downsampling=4,
                        val_subsets=("test-clean",)),
        train=TrainConfig(batch_size=32),
    )
    return cfg.replace(**overrides)


def siamese_verification(**overrides) -> ExperimentConfig:
    """Config #2: siamese 1D-conv verification net on train-clean-100."""
    cfg = ExperimentConfig(
        name="siamese_verification",
        mode="siamese",
        data=DataConfig(subsets=("train-clean-100",), seconds=3.0, downsampling=4,
                        val_subsets=("dev-clean",)),
        encoder=EncoderConfig(dropout=0.0),
        train=TrainConfig(batch_size=64, loss="bce"),
    )
    return cfg.replace(**overrides)


def dilated_4khz(**overrides) -> ExperimentConfig:
    """Config #3: 4 kHz waveform, deeper dilated conv1d stack."""
    cfg = ExperimentConfig(
        name="dilated_4khz",
        mode="classifier",
        data=DataConfig(subsets=("dev-clean",), seconds=3.0, downsampling=4,
                        val_subsets=("test-clean",)),
        encoder=EncoderConfig(
            filters=128,
            filter_multipliers=(1, 1, 2, 2, 3, 3, 4, 4),
            kernel_sizes=(32, 3, 3, 3, 3, 3, 3, 3),
            pool_sizes=(4, 1, 2, 1, 2, 1, 2, 1),
            dilations=(1, 2, 1, 4, 1, 8, 1, 16),
        ),
    )
    return cfg.replace(**overrides)


def melspec_2d(**overrides) -> ExperimentConfig:
    """Config #4: log-mel frontend + 2D-CNN embedder (hop 128, window 384)."""
    cfg = ExperimentConfig(
        name="melspec_2d",
        mode="melspec2d",
        data=DataConfig(subsets=("dev-clean",), seconds=3.0, downsampling=1,
                        val_subsets=("test-clean",),
                        whiten_rms=DEFAULT_WHITEN_RMS),
        mel=MelConfig(hop_length=128, win_length=384),
    )
    return cfg.replace(**overrides)


PRESETS = {
    "classifier_baseline": classifier_baseline,
    "siamese_verification": siamese_verification,
    "dilated_4khz": dilated_4khz,
    "melspec_2d": melspec_2d,
}


# ---------------------------------------------------------------------------
# The port's own configurations (no JAX counterpart)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EcapaConfig:
    """ECAPA-TDNN (Desplanques, Thienpondt and Demuynck, Interspeech 2020) at
    the widths of SpeechBrain's ``spkrec-ecapa-voxceleb``: a TDNN layer,
    SE-Res2Net blocks, multi-layer feature aggregation (MFA), attentive
    statistics pooling with global context, BatchNorm and a linear layer.
    ``channels``, ``kernel_sizes`` and ``dilations`` list layer 1, each
    SE-Res2Net block and the MFA TDNN, in that order."""

    channels: Tuple[int, ...] = (1024, 1024, 1024, 1024, 3072)
    kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    res2net_scale: int = 8
    se_channels: int = 128
    attention_channels: int = 128
    embedding_dim: int = 192
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    bn_epsilon: float = 1e-5  # torch's BatchNorm1d default, as SpeechBrain's


@dataclass(frozen=True)
class EcapaExperimentConfig(ExperimentConfig):
    """An experiment whose model is ECAPA-TDNN (``mode="ecapa_tdnn"``),
    trained as SpeechBrain's VoxCeleb recipe (``train_ecapa_tdnn.yaml``)
    trains it: the additive angular margin softmax at ``aam_margin`` and
    ``aam_scale`` over the cosine head, Adam with ``weight_decay``."""

    ecapa: EcapaConfig = field(default_factory=EcapaConfig)
    aam_margin: float = 0.2
    aam_scale: float = 30.0
    weight_decay: float = 2e-6


def ecapa_tdnn(**overrides) -> EcapaExperimentConfig:
    """ECAPA-TDNN (C = 1024) on 3 s at 16 kHz, undecimated and unwhitened
    (÷ 32768 only), through an 80-band log-mel front end (n_fft 400, window
    400, hop 160, 0–8 kHz), embedding 192; trained at the recipe's 32 a
    batch, learning rate 1e-3 (its cyclic schedule's peak, held) and the
    gradient clipped at global norm 5."""
    cfg = EcapaExperimentConfig(
        name="ecapa_tdnn",
        mode="ecapa_tdnn",
        data=DataConfig(subsets=("train-clean-100",), seconds=3.0, downsampling=1,
                        val_subsets=("dev-clean",), whiten_rms=None),
        mel=MelConfig(n_fft=400, hop_length=160, win_length=400, n_mels=80, fmin=0.0,
                      fmax=8000.0),
        train=TrainConfig(batch_size=32, learning_rate=1e-3, clipnorm=5.0),
    )
    return cfg.replace(**overrides)


PORT_PRESETS = {**PRESETS, "ecapa_tdnn": ecapa_tdnn}
