"""voicemap_tpu_torch — the PyTorch and CUDA port of ``voicemap_tpu``.

The JAX package stays the reference; this package runs the same functions on
an NVIDIA GPU. Module names mirror the JAX package, so each port module sits
where its counterpart does:

- :mod:`voicemap_tpu_torch.config` — a copy of the JAX package's dataclass
  configs and presets
- :mod:`voicemap_tpu_torch.data` — the pandas-free corpus container
- :mod:`voicemap_tpu_torch.ops` — preprocess, sampling, distances, the
  log-mel reference (``melspec``), the replay of JAX's key stream
  (``jax_random``), the hand-written CUDA kernels
  (``cuda_preprocess``, ``cuda_conv``, ``cuda_quant_block``,
  ``cuda_conv_train``, ``cuda_routing``, ``cuda_melspec``,
  ``cuda_distance``) and the fused train blocks' autograd Functions
  (``conv_train``)
- :mod:`voicemap_tpu_torch.models` — conv encoder (eval and train mode),
  classifier, the siamese verification net (``siamese``), the log-mel 2D models of config #4 (``spectrogram``), fast
  inference, the pooled-GEMM specification of the fused blocks
  (``fused_encoder``), the fused train forward, int8 serving (``quant_infer``),
  flax-tree and qvars converters
- :mod:`voicemap_tpu_torch.train` — the device store, batch fetch, the
  classifier and siamese train steps, losses, optimizer, metrics, checkpoints and ``fit``
- :mod:`voicemap_tpu_torch.eval` — batched n-shot k-way evaluation and its
  k sweep, threshold-free verification (EER, AUC) and the frozen protocol
  (``EVAL_PROTOCOL.json``) with the int8 decision gate
- :mod:`voicemap_tpu_torch.experiments` — the five experiment CLIs
  (``python -m voicemap_tpu_torch.experiments.<name>``)
- :mod:`voicemap_tpu_torch.utils` — CUDA-event timing and request latency,
  traces, the serving and train-step profilers and the int8 mid block's
  stage attribution

Public functions keep the JAX layout: ``(B, T, C)`` activations, ``(B, T, 1)``
model input, ``(B, D)`` float32 embeddings. Models are built on the card
unless asked otherwise. Nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
