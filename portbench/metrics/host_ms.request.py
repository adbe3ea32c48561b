"""Host dispatch inside the program: milliseconds of the profiler's clock
in which one of the program's ``voicemap.*`` spans was open on the host (the
union of their host intervals, so the outermost ones) over the requests of
the traced window. None where the program has no such spans."""

from portbench.trace import merge

PREFIX = "voicemap."


def read(t):
    if t.work["requests"] == 0:
        return None
    inside = merge([(s, e) for n, s, e in t.host if n.startswith(PREFIX)])
    if not inside:
        return None
    return sum(e - s for s, e in inside) / 1e3 / t.work["requests"]
