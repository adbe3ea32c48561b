"""The whole embed step: conv FLOPs of every utterance embedded in the traced
window (``counts.embed_flops``) over the window and the bf16 dense peak, in
percent."""

from portbench import counts


def read(t):
    if not t.device or t.work["utterances"] == 0:
        return None
    flops = counts.embed_flops(t.config) * t.work["utterances"]
    return 100.0 * flops / t.window_s / counts.BF16_OPS_PER_S
