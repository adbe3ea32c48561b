"""Operations, bytes and the least time of the port's layers, from shapes.

A frozen copy of ``chip_smoke.py``'s arithmetic, so that a later change there
cannot move the benchmark's yardstick:

- the published H100 SXM peaks (``chip_smoke.py``: ``HBM_BYTES_PER_S``,
  ``BF16_OPS_PER_S``, ``INT8_OPS_PER_S``, ``TF32_OPS_PER_S``,
  ``F32_OPS_PER_S``; NVIDIA's data sheet, dense rates);
- ``chip_smoke.bound``: the larger of bytes over the memory rate and
  operations over the type's peak;
- the per-kernel operations and bytes of ``chip_smoke.run_timing`` (B2,
  block 0), ``chip_smoke.time_blockn`` (B8, blocks 1+) and
  ``chip_smoke.run_train_timing`` (B7's two passes): every input byte read
  once and every output byte written once.

The conv FLOPs of a whole step are 2 × MACs of every block at its input
length; a training step counts three times the forward, less block 0's
input gradient, which no step computes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
TF32_OPS_PER_S = 495e12
F32_OPS_PER_S = 67e12  # CUDA cores, outside the tensor cores


def bound_s(bytes_moved: float, ops: float, ops_per_s: float) -> float:
    """The least seconds the card could take (``chip_smoke.bound``)."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)


def blocks(config: dict) -> list:
    """Each block of an encoder config at one utterance: ``dict(T, cin,
    cout, k, pool, dilation)``, ``T`` the block's input length (its conv
    runs at it, SAME padding)."""
    enc, data = config["encoder"], config["data"]
    t = int(data["seconds"] * data["sample_rate"]) // data["downsampling"]
    out, cin = [], 1
    for mult, k, pool, dil in zip(enc["filter_multipliers"], enc["kernel_sizes"],
                                  enc["pool_sizes"], enc["dilations"]):
        cout = enc["filters"] * mult
        out.append(dict(T=t, cin=cin, cout=cout, k=k, pool=max(pool, 1), dilation=dil))
        t //= max(pool, 1)
        cin = cout
    return out


def conv_flops(block: dict) -> float:
    """FLOPs of one block's conv for one utterance: 2 × T·k·Cin·Cout."""
    return 2.0 * block["T"] * block["k"] * block["cin"] * block["cout"]


def embed_flops(config: dict) -> float:
    """Conv FLOPs of one utterance's forward."""
    return sum(conv_flops(b) for b in blocks(config))


def train_flops(config: dict) -> float:
    """Conv FLOPs of one utterance's train step: forward, input gradient and
    weight gradient of every block, without block 0's input gradient."""
    return 3.0 * embed_flops(config) - conv_flops(blocks(config)[0])


def block0_bound_s(config: dict, batch: int) -> float:
    """B2 at ``batch`` rows: f32 input read, bf16 output written
    (``chip_smoke.run_timing``'s ``conv_block0``), the conv at the bf16
    rate."""
    b0 = blocks(config)[0]
    moved = batch * b0["T"] * 4 + batch * (b0["T"] // b0["pool"]) * b0["cout"] * 2
    return bound_s(moved, batch * conv_flops(b0), BF16_OPS_PER_S)


def blockn_bound_s(block: dict, batch: int) -> float:
    """B8 on one block 1+ at ``batch`` rows (``chip_smoke.time_blockn``):
    the bf16 input, the f32 weights and five f32 vectors, the pooled bf16
    output; the conv at the bf16 rate."""
    T, cin, cout, k, pool = block["T"], block["cin"], block["cout"], block["k"], block["pool"]
    moved = batch * T * cin * 2 + k * cin * cout * 4 + 5 * cout * 4 + batch * (T // pool) * cout * 2
    return bound_s(moved, batch * conv_flops(block), BF16_OPS_PER_S)


def routing_bound_s(block: dict, batch: int) -> float:
    """B7's pool pass and routing pass on one block 1+ at ``batch`` rows
    (``chip_smoke.run_train_timing``). Forward: z and a_sel in bf16, the bias,
    sign and two sums; 8 f32 operations an element. Backward: z, a_sel, the
    f32 cotangent, dz, and five vectors; 12 an element. On the CUDA cores."""
    C, T, pool = block["cout"], block["T"], block["pool"]
    full, half = batch * C * T, batch * C * (T // pool)
    fwd = bound_s(full * 2 + half * 2 + 4 * C * 4, 8.0 * full, F32_OPS_PER_S)
    bwd = bound_s(full * 2 + half * 2 + half * 4 + full * 2 + 5 * C * 4, 12.0 * full,
                  F32_OPS_PER_S)
    return fwd + bwd
