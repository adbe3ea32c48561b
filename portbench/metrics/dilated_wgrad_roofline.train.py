"""The dilated convs' weight gradient in training (``ops/cuda_wgrad``; the
``conv.wgrad.<i>`` spans around its launches, one a dilated block i a
backward): the least time of their work (``counts_wgrad.wgrad_bound_s`` of
block i at each span's rows) over the spans' device seconds, in percent.
None where the program has no such spans."""

import re

from portbench import counts, counts_wgrad

SPAN = re.compile(r"conv\.wgrad\.(\d+)$")


def read(t):
    try:
        from voicemap_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    blocks = counts.blocks(t.config)
    bound = spent = 0.0
    for r in spans():
        m = SPAN.match(r.name)
        if m and r.ms is not None and r.rows:
            bound += counts_wgrad.wgrad_bound_s(blocks[int(m.group(1))], r.rows)
            spent += r.ms / 1e3
    return 100.0 * bound / spent if spent > 0 else None
