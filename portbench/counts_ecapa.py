"""Operations, bytes and the least time of ECAPA-TDNN's stages, from the
configuration's widths (``configs/ecapa_tdnn.json``).

The peaks, ``bound_s`` and B8's per-kernel formula (``blockn_bound_s``: the
bf16 input, the f32 weights and five f32 vectors, the bf16 output; the conv
at the bf16 rate) are ``counts.py``'s, imported and not changed. A stage's
least time is the sum of its operations' least times, each operation
reading each input byte once and writing each output byte once: a TDNN by
B8's formula, a memory pass by its bytes at the HBM rate.

The forward's FLOPs (``embed_flops``) are the model's as published: every
TDNN (ASP's over its 3C-channel input), the SE and pooling convs and the
linear layer, 2 × their multiply-adds; the front end is not counted.
"""

from __future__ import annotations

from . import counts

BF16, F32 = 2, 4  # bytes an activation in the compute dtype, a statistic


def frames(config: dict) -> int:
    """Log-mel frames of one window: uncentred, ``1 + (N − win) // hop``."""
    d, mel = config["data"], config["mel"]
    n = int(d["seconds"] * d["sample_rate"])
    return 1 + (n - mel["win_length"]) // mel["hop_length"]


def _tdnn(T: int, cin: int, cout: int, k: int) -> dict:
    """A TDNN as ``counts.blockn_bound_s`` takes a block, at pool 1."""
    return dict(T=T, cin=cin, cout=cout, k=k, pool=1, dilation=1)


def tdnn_flops(config: dict) -> dict:
    """FLOPs of one window by stage: ``layer1``, ``block`` (each of the
    SE-Res2Net blocks), ``mfa``, ``asp``, ``head``."""
    enc, T = config["encoder"], frames(config)
    C, ks, scale = enc["channels"], enc["kernel_sizes"], enc["res2net_scale"]
    A, S = enc["attention_channels"], enc["se_channels"]
    c, w = C[1], C[1] // scale
    conv = counts.conv_flops
    return {
        "layer1": conv(_tdnn(T, config["mel"]["n_mels"], C[0], ks[0])),
        "block": (2 * conv(_tdnn(T, c, c, 1)) + (scale - 1) * conv(_tdnn(T, w, w, ks[1]))
                  + 2.0 * 2 * c * S),
        "mfa": conv(_tdnn(T, sum(C[1:-1]), C[-1], ks[-1])),
        "asp": conv(_tdnn(T, 3 * C[-1], A, 1)) + conv(_tdnn(T, A, C[-1], 1)),
        "head": 2.0 * 2 * C[-1] * enc["embedding_dim"],
    }


def embed_flops(config: dict) -> float:
    """FLOPs of one window's forward."""
    f = tdnn_flops(config)
    return f["layer1"] + (len(config["encoder"]["channels"]) - 2) * f["block"] + f["mfa"] + \
        f["asp"] + f["head"]


def block_bound_s(config: dict, batch: int) -> float:
    """One SE-Res2Net block at ``batch`` windows: its two 1×1 TDNNs and
    ``scale − 1`` Res2Net TDNNs by B8's formula, and the SE gate and residual
    add as one pass (read the second TDNN's output and the block's input,
    write the block's output)."""
    enc, T = config["encoder"], frames(config)
    c, scale = enc["channels"][1], enc["res2net_scale"]
    w = c // scale
    tdnns = (2 * counts.blockn_bound_s(_tdnn(T, c, c, 1), batch)
             + (scale - 1) * counts.blockn_bound_s(_tdnn(T, w, w, enc["kernel_sizes"][1]), batch))
    return tdnns + 3.0 * batch * T * c * BF16 / counts.HBM_BYTES_PER_S


def mfa_bound_s(config: dict, batch: int) -> float:
    """MFA at ``batch`` windows: B8 as a 3C × C GEMM over B·T rows."""
    enc = config["encoder"]
    C = enc["channels"]
    mfa = _tdnn(frames(config), sum(C[1:-1]), C[-1], enc["kernel_sizes"][-1])
    return counts.blockn_bound_s(mfa, batch)


def asp_bound_s(config: dict, batch: int) -> float:
    """Attentive statistics pooling at ``batch`` windows, four operations:
    the global mean and std (read h, write two f32 rows a window); the TDNN
    on h with the per-window context term (B8's formula at Cin = C: the
    mean and std columns are constant in time); tanh and the 1×1 conv A → C
    (read the TDNN's output, write the logits); the softmax and the weighted
    mean and std (read the logits and h, write 2C f32 a window)."""
    enc, T = config["encoder"], frames(config)
    C, A = enc["channels"][-1], enc["attention_channels"]
    rows = batch * T
    hbm = lambda b: b / counts.HBM_BYTES_PER_S  # noqa: E731
    stats = hbm(rows * C * BF16 + batch * 2 * C * F32)
    tdnn = counts.blockn_bound_s(_tdnn(T, C, A, 1), batch)
    conv = counts.bound_s(rows * A * BF16 + rows * C * BF16 + A * C * F32,
                          2.0 * rows * A * C, counts.BF16_OPS_PER_S)
    pool = hbm(2 * rows * C * BF16 + batch * 2 * C * F32)
    return stats + tdnn + conv + pool
