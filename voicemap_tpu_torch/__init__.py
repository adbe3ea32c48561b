"""voicemap_tpu_torch — the PyTorch and CUDA port of ``voicemap_tpu``.

The JAX package stays the reference; this package runs the same functions on
an NVIDIA GPU. Module names mirror the JAX package, so each port module sits
where its counterpart does:

- :mod:`voicemap_tpu_torch.config` — a copy of the JAX package's dataclass
  configs and presets
- :mod:`voicemap_tpu_torch.data` — the pandas-free corpus container
- :mod:`voicemap_tpu_torch.ops` — preprocess, sampling, distances and the
  hand-written CUDA kernels (``cuda_preprocess``, ``cuda_conv``,
  ``cuda_quant_block``)
- :mod:`voicemap_tpu_torch.models` — conv encoder, classifier, fast inference,
  int8 serving (``quant_infer``), flax-tree and qvars converters
- :mod:`voicemap_tpu_torch.train` — the device store and batch fetch
- :mod:`voicemap_tpu_torch.eval` — batched n-shot k-way evaluation
- :mod:`voicemap_tpu_torch.utils` — CUDA-event timing

Public functions keep the JAX layout: ``(B, T, C)`` activations, ``(B, T, 1)``
model input, ``(B, D)`` float32 embeddings. Models are built on the card
unless asked otherwise. Nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
