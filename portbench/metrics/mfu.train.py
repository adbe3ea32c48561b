"""The whole train step: conv FLOPs of every utterance trained in the traced
window (``counts.train_flops``: forward, input and weight gradients, without
block 0's input gradient) over the window and the bf16 dense peak, in
percent."""

from portbench import counts


def read(t):
    if not t.device or t.work["steps"] == 0:
        return None
    flops = counts.train_flops(t.config) * t.work["utterances"]
    return 100.0 * flops / t.window_s / counts.BF16_OPS_PER_S
