"""Configuration: the JAX package's dataclasses and presets, re-exported.

``voicemap_tpu.config`` uses only the standard library, so both packages share
one definition of every config and preset instead of two copies that could
drift.
"""

from voicemap_tpu.config import (  # noqa: F401
    DEFAULT_WHITEN_RMS,
    LIBRISPEECH_SAMPLING_RATE,
    PRESETS,
    DataConfig,
    EncoderConfig,
    ExperimentConfig,
    MelConfig,
    SiameseConfig,
    TrainConfig,
    classifier_baseline,
    dilated_4khz,
    melspec_2d,
    siamese_verification,
)
