"""ECAPA-TDNN's attentive statistics pooling (the ``ecapa.asp`` span: the
global mean and std, the TDNN, tanh and the 1×1 conv, the softmax over time
and the weighted mean and std): the least time of its work
(``counts_ecapa.asp_bound_s`` at each span's rows) over the spans' device
seconds, in percent. None where the program has no such spans."""

from portbench import counts_ecapa

SPAN = "ecapa.asp"


def read(t):
    try:
        from voicemap_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    bound = spent = 0.0
    for r in spans():
        if r.name == SPAN and r.ms is not None:
            bound += counts_ecapa.asp_bound_s(t.config, r.rows)
            spent += r.ms / 1e3
    return 100.0 * bound / spent if spent > 0 else None
