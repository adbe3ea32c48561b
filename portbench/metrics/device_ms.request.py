"""The device a request: milliseconds in which any device operation ran (the
union of their intervals), over the requests of the traced window."""


def read(t):
    if not t.device or t.work["requests"] == 0:
        return None
    return 1e3 * t.busy_s / t.work["requests"]
