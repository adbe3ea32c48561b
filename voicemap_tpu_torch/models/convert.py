"""Flax variable tree → the port's ``state_dict``; JAX qvars → the port's.

Maps the JAX package's parameters onto :class:`ConvEncoder` and
:class:`SpeakerClassifier` so that both packages run the same weights:

- conv ``kernel (k, Cin, Cout)`` → ``Conv1d.weight (Cout, Cin, k)``;
- Dense ``kernel (in, out)`` → ``Linear.weight (out, in)``;
- ``bn/scale, bias`` with ``batch_stats/.../bn/mean, var`` → ``BatchNorm1d``
  (its epsilon, 1e-3, is set by the module from the config).

Takes either the classifier's tree (``params/encoder/block_i/...``,
``params/encoder/embed``, ``params/head``) or the bare encoder's.
``to_flax`` is the inverse: a ``state_dict``, or a dict of gradients keyed by
parameter name, back to the flax tree as numpy arrays, so the tests can hold
the port's gradients, updated parameters and batch statistics against the
JAX package's leaf by leaf.
``qvars_from_numpy`` maps an int8 serving artifact of the JAX package
(``models/quant_infer.quantize_encoder``) onto the port's tensors; the layout
is the same in both packages. Leaves may be numpy arrays or anything
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


def _encoder_state(params: dict, stats: dict, cfg: EncoderConfig,
                   prefix: str) -> Dict[str, torch.Tensor]:
    sd = {}
    for i in range(len(cfg.filter_multipliers)):
        p = params[f"block_{i}"]
        s = stats[f"block_{i}"]["bn"]
        pre = f"{prefix}blocks.{i}."
        sd[pre + "conv.weight"] = _t(p["conv"]["kernel"], (2, 1, 0))
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
    ``s0`` and the epilogue vectors f32, ``w_q (3, Cin, Cout)`` int8."""
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
            "conv": {"kernel": _n(sd[pre + "conv.weight"], (2, 1, 0)),
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
