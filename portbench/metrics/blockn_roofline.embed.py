"""Blocks 1+ (``models.fast_infer.blockn`` → B8, ``csrc/conv_blockn.cu``):
the least time of their work in the traced window (``counts.blockn_bound_s``
for every block 1+ of every batch) over the device time of B8's kernel, in
percent."""

from portbench import counts

KERNEL = r"\bconv_blockn_kernel\b"


def read(t):
    spent = t.seconds_of(KERNEL)
    if spent <= 0:
        return None
    later = counts.blocks(t.config)[1:]
    bound = sum(counts.blockn_bound_s(b, rows) for rows in t.work["batches"] for b in later)
    return 100.0 * bound / spent
