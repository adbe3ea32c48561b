"""ECAPA-TDNN's SE-Res2Net blocks (``models.ecapa``'s ``ecapa.block.<i>``
spans, i = 1-3): the least time of their work (``counts_ecapa.block_bound_s``
at each span's rows: the TDNNs by B8's formula, the SE gate and residual
add as one pass) over the spans' device seconds (CUDA events at their
edges), in percent. None where the program has no such spans."""

from portbench import counts_ecapa

PREFIX = "ecapa.block."


def read(t):
    try:
        from voicemap_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    bound = spent = 0.0
    for r in spans():
        if r.name.startswith(PREFIX) and r.ms is not None:
            bound += counts_ecapa.block_bound_s(t.config, r.rows)
            spent += r.ms / 1e3
    return 100.0 * bound / spent if spent > 0 else None
