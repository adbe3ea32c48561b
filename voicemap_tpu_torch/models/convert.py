"""Flax variable tree → the port's ``state_dict``; JAX qvars → the port's.

Maps the JAX package's parameters onto :class:`ConvEncoder`,
:class:`SpeakerClassifier` and the log-mel 2D models
(:class:`MelSpecEncoder`, :class:`MelSpecClassifier`; their frontend has no
parameters) so that both packages run the same weights:

- 1D conv ``kernel (k, Cin, Cout)`` → ``Conv1d.weight (Cout, Cin, k)``;
- 2D conv ``kernel (3, 3, Cin, Cout)`` (HWIO) → ``Conv2d.weight (Cout, Cin, 3, 3)``;
- Dense ``kernel (in, out)`` → ``Linear.weight (out, in)``;
- ``bn/scale, bias`` with ``batch_stats/.../bn/mean, var`` → ``BatchNorm1d``
  or ``BatchNorm2d`` (its epsilon, 1e-3, is set by the module from the config).

Takes either the classifier's tree (``params/encoder/block_i/...``,
``params/encoder/embed``, ``params/head``) or the bare encoder's. The
siamese net's tree (:class:`SiameseNet`) is the same ``encoder`` + ``head``
tree: its Dense(1) kernel ``(D, 1)`` (``(1, 1)`` for the metrics that merge a
pair to one value) maps to ``head.weight (1, D)`` and back by the same
transpose, with its bias ``(1,)`` as it is.
``to_flax`` is the inverse: a ``state_dict``, or a dict of gradients keyed by
parameter name, back to the flax tree as numpy arrays, so the tests can hold
the port's gradients, updated parameters and batch statistics against the
JAX package's leaf by leaf.
``variables_of`` is the same tree over a live 1D model's tensors, as views
in flax's layouts that stay on the device and in autograd (the parallel
programs of ``parallel/`` take it where the JAX functions take ``variables``).
``qvars_from_numpy`` maps an int8 serving artifact of the JAX package
(``models/quant_infer.quantize_encoder``, or ``quantize_mel_encoder`` with its
0-d ``s0`` and 4-D ``w_q``) onto the port's tensors; the layout is the same
in both packages. Leaves may be numpy arrays or anything
``np.asarray`` reads; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import EncoderConfig


def _t(a, transpose=None) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.tensor(a.transpose(transpose) if transpose else a)  # a copy


# conv kernel rank → the axes from flax's layout to torch's, and back.
_TO_TORCH = {3: (2, 1, 0), 4: (3, 2, 0, 1)}
_TO_FLAX = {3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _encoder_state(params: dict, stats: dict, cfg: EncoderConfig,
                   prefix: str) -> Dict[str, torch.Tensor]:
    sd = {}
    for i in range(len(cfg.filter_multipliers)):
        p = params[f"block_{i}"]
        s = stats[f"block_{i}"]["bn"]
        pre = f"{prefix}blocks.{i}."
        kernel = p["conv"]["kernel"]
        sd[pre + "conv.weight"] = _t(kernel, _TO_TORCH[np.ndim(kernel)])
        sd[pre + "conv.bias"] = _t(p["conv"]["bias"])
        sd[pre + "bn.weight"] = _t(p["bn"]["scale"])
        sd[pre + "bn.bias"] = _t(p["bn"]["bias"])
        sd[pre + "bn.running_mean"] = _t(s["mean"])
        sd[pre + "bn.running_var"] = _t(s["var"])
        sd[pre + "bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    sd[prefix + "embed.weight"] = _t(params["embed"]["kernel"], (1, 0))
    sd[prefix + "embed.bias"] = _t(params["embed"]["bias"])
    return sd


def from_flax(variables: dict, cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` → ``state_dict`` of the
    classifier (tree with ``encoder`` and ``head``) or of the bare encoder."""
    params = variables["params"]
    stats = variables["batch_stats"]
    if "encoder" not in params:
        return _encoder_state(params, stats, cfg, "")
    sd = _encoder_state(params["encoder"], stats["encoder"], cfg, "encoder.")
    if "head" in params:
        sd["head.weight"] = _t(params["head"]["kernel"], (1, 0))
        sd["head.bias"] = _t(params["head"]["bias"])
    return sd


def qvars_from_numpy(qvars: dict, device="cuda") -> dict:
    """The JAX package's qvars dict → the port's, with tensors on ``device``:
    ``s0`` and the epilogue vectors f32, ``w_q`` int8: ``(3, Cin, Cout)``
    for a waveform artifact, ``(3, 3, Cin, Cout)`` beside a 0-d ``s0`` for a
    mel one (``kind="mel"``)."""
    def put(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)

    out = {"s0": put(qvars["s0"], np.float32),
           "blocks": [{"w_q": put(b["w_q"], np.int8),
                       **{k: put(b[k], np.float32) for k in ("alpha", "beta", "gamma")}}
                      for b in qvars["blocks"]]}
    if "kind" in qvars:
        out["kind"] = str(qvars["kind"])
    return out


def _n(t, transpose=None) -> np.ndarray:
    a = t.detach().float().cpu().numpy()
    return np.ascontiguousarray(a.transpose(transpose)) if transpose else a


def _encoder_tree(sd: dict, cfg: EncoderConfig, prefix: str) -> tuple[dict, dict]:
    params, stats = {}, {}
    for i in range(len(cfg.filter_multipliers)):
        pre = f"{prefix}blocks.{i}."
        params[f"block_{i}"] = {
            "conv": {"kernel": _n(sd[pre + "conv.weight"],
                                  _TO_FLAX[sd[pre + "conv.weight"].dim()]),
                     "bias": _n(sd[pre + "conv.bias"])},
            "bn": {"scale": _n(sd[pre + "bn.weight"]), "bias": _n(sd[pre + "bn.bias"])},
        }
        if pre + "bn.running_mean" in sd:
            stats[f"block_{i}"] = {"bn": {"mean": _n(sd[pre + "bn.running_mean"]),
                                          "var": _n(sd[pre + "bn.running_var"])}}
    params["embed"] = {"kernel": _n(sd[prefix + "embed.weight"], (1, 0)),
                       "bias": _n(sd[prefix + "embed.bias"])}
    return params, stats


def to_flax(sd: Dict[str, torch.Tensor], cfg: EncoderConfig) -> dict:
    """A ``state_dict`` (or ``{name: grad}``) → ``{"params": ...}`` in flax's
    layout, with ``"batch_stats"`` when the running statistics are there.
    The inverse of :func:`from_flax`."""
    if not any(k.startswith("encoder.") for k in sd):
        params, stats = _encoder_tree(sd, cfg, "")
    else:
        enc, enc_stats = _encoder_tree(sd, cfg, "encoder.")
        params, stats = {"encoder": enc}, {"encoder": enc_stats}
        if "head.weight" in sd:
            params["head"] = {"kernel": _n(sd["head.weight"], (1, 0)),
                              "bias": _n(sd["head.bias"])}
    out = {"params": params}
    if any(k.endswith("running_mean") for k in sd):
        out["batch_stats"] = stats
    return out


def _encoder_views(encoder) -> tuple[dict, dict]:
    params, stats = {}, {}
    for i, blk in enumerate(encoder.blocks):
        params[f"block_{i}"] = {
            "conv": {"kernel": blk.conv.weight.permute(2, 1, 0), "bias": blk.conv.bias},
            "bn": {"scale": blk.bn.weight, "bias": blk.bn.bias}}
        stats[f"block_{i}"] = {"bn": {"mean": blk.bn.running_mean, "var": blk.bn.running_var}}
    params["embed"] = {"kernel": encoder.embed.weight.t(), "bias": encoder.embed.bias}
    return params, stats


def variables_of(model) -> dict:
    """A 1D ``ConvEncoder`` or ``SpeakerClassifier`` → ``{"params": ...,
    "batch_stats": ...}`` in flax's tree and layouts, every leaf a view of
    the module's own tensor (conv kernels ``(k, Cin, Cout)``, Dense kernels
    ``(in, out)``): gradients through a leaf land in the parameter's
    ``.grad``, and writing a statistic writes the module's buffer."""
    if hasattr(model, "encoder"):
        params, stats = _encoder_views(model.encoder)
        out = {"params": {"encoder": params}, "batch_stats": {"encoder": stats}}
        out["params"]["head"] = {"kernel": model.head.weight.t(), "bias": model.head.bias}
        return out
    params, stats = _encoder_views(model)
    return {"params": params, "batch_stats": stats}
