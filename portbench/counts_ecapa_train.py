"""Operations and the least time of ECAPA-TDNN's training step, from the
configuration's widths (``configs/ecapa_tdnn_train.json``) and the cell's number
of classes, beside ``counts_ecapa.py`` (whose forward count and peaks it
takes, unchanged).

- ``train_flops``: a step's FLOPs an utterance, the published model's: the
  forward (``counts_ecapa.embed_flops``), and the input and weight
  gradients of every TDNN, SE and pooling conv and linear layer (each twice
  its forward), less layer 1's input gradient (its input is the front end's,
  which needs none); plus the cosine head's GEMM over the classes, forward
  and both gradients (3 × 2 × D × classes). The front end is not counted.
- ``asp_bwd_bound_s``: the least time of one launch of ASP's backward, a
  memory pass: ``h`` (and the logits) read once, dh (and dlogits) written
  once in the compute dtype, and the f32 statistics of each (utterance,
  channel) read once (the mean, std and their two gradients; the weighted
  mode also the softmax's max and sum), at the HBM rate.
"""

from __future__ import annotations

from . import counts, counts_ecapa

BF16, F32 = counts_ecapa.BF16, counts_ecapa.F32


def train_flops(config: dict, num_classes: int) -> float:
    """FLOPs of one utterance's train step."""
    D = config["encoder"]["embedding_dim"]
    return (3.0 * counts_ecapa.embed_flops(config) - counts_ecapa.tdnn_flops(config)["layer1"]
            + 3.0 * 2 * D * num_classes)


def asp_bwd_bound_s(config: dict, batch: int, weighted: bool = True) -> float:
    """One launch of ASP's backward at ``batch`` windows, weighted (h and
    the logits in, dh and dlogits out) or unweighted (h in, dh out)."""
    T, C = counts_ecapa.frames(config), config["encoder"]["channels"][-1]
    tensors, stats = (4, 6) if weighted else (2, 4)
    moved = tensors * batch * T * C * BF16 + stats * batch * C * F32
    return moved / counts.HBM_BYTES_PER_S
