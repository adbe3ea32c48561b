"""B7 (``ops.cuda_routing`` → ``csrc/routing.cu``), forward and backward: the
least time of its pool and routing passes over every block 1+ of every step
in the traced window (``counts.routing_bound_s``) over the device time of
its two kernels, in percent."""

from portbench import counts

KERNELS = r"\b(pool_fwd_kernel|route_bwd_kernel)\b"


def read(t):
    spent = t.seconds_of(KERNELS)
    if spent <= 0:
        return None
    per_step = sum(counts.routing_bound_s(b, t.work["batch_size"])
                   for b in counts.blocks(t.config)[1:])
    return 100.0 * per_step * t.work["steps"] / spent
