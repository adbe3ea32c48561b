"""ECAPA-TDNN's whole embed step: the forward's FLOPs of every utterance
embedded in the traced window (``counts_ecapa.embed_flops``: every TDNN, the
SE and pooling convs, the linear layer) over the window and the bf16 dense
peak, in percent."""

from portbench import counts, counts_ecapa


def read(t):
    if not t.device or t.work["utterances"] == 0:
        return None
    flops = counts_ecapa.embed_flops(t.config) * t.work["utterances"]
    return 100.0 * flops / t.window_s / counts.BF16_OPS_PER_S
