"""Blocks 1+ one at a time (``models.fast_infer.fast_trunk``'s
``blockn.<i>`` spans: B8 where it takes the block): for each block i ≥ 1,
the least time of its work (``counts.blockn_bound_s`` at each span's rows)
over its spans' device seconds (CUDA events at their edges), in percent;
the block furthest from its bound. None where the program has no such
spans."""

from portbench import counts

PREFIX = "blockn."


def read(t):
    try:
        from voicemap_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    blocks = counts.blocks(t.config)
    bound, spent = {}, {}
    for r in spans():
        if r.name.startswith(PREFIX) and r.ms is not None:
            i = int(r.name[len(PREFIX):])
            bound[i] = bound.get(i, 0.0) + counts.blockn_bound_s(blocks[i], r.rows)
            spent[i] = spent.get(i, 0.0) + r.ms / 1e3
    shares = [100.0 * bound[i] / spent[i] for i in bound if spent[i] > 0]
    return min(shares) if shares else None
