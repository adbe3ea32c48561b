"""ECAPA-TDNN's whole train step: the FLOPs of every utterance trained in the
traced window (``counts_ecapa_train.train_flops``: the forward, the input
and weight gradients of every TDNN, SE and pooling conv and linear layer
less layer 1's input gradient, and the cosine head's GEMM over the store's
speakers) over the window and the bf16 dense peak, in percent."""

from portbench import counts, counts_ecapa_train


def read(t):
    if not t.device or t.work["steps"] == 0:
        return None
    classes = int(t.traffic["store"]["speakers"])
    flops = counts_ecapa_train.train_flops(t.config, classes) * t.work["utterances"]
    return 100.0 * flops / t.window_s / counts.BF16_OPS_PER_S
