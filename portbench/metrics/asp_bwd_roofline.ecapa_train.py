"""ECAPA-TDNN's ASP backward kernel (``ops/cuda_asp``; the ``ecapa.asp_bwd``
spans around the weighted mode's launches, ``ecapa.asp_bwd.global`` around
the unweighted mode's): the least time of their work
(``counts_ecapa_train.asp_bwd_bound_s`` at each span's rows, by mode) over
the spans' device seconds, in percent. None where the program has no such
spans."""

from portbench import counts_ecapa_train

SPANS = {"ecapa.asp_bwd": True, "ecapa.asp_bwd.global": False}


def read(t):
    try:
        from voicemap_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    bound = spent = 0.0
    for r in spans():
        if r.name in SPANS and r.ms is not None:
            bound += counts_ecapa_train.asp_bwd_bound_s(t.config, r.rows, SPANS[r.name])
            spent += r.ms / 1e3
    return 100.0 * bound / spent if spent > 0 else None
