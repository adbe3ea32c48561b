"""Block 0 (B2, ``csrc/conv_block0.cu``): the least time of its work in the
traced window (``counts.block0_bound_s`` for every batch) over the device
time of B2's kernels, in percent."""

from portbench import counts

KERNEL = r"\bconv_block0(_tc)?_kernel\b"


def read(t):
    spent = t.seconds_of(KERNEL)
    if spent <= 0:
        return None
    bound = sum(counts.block0_bound_s(t.config, rows) for rows in t.work["batches"])
    return 100.0 * bound / spent
