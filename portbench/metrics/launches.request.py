"""Host dispatch: device kernels launched a request in the traced window
(copies and fills not counted)."""


def read(t):
    if not t.device or t.work["requests"] == 0:
        return None
    return len(t.kernels()) / t.work["requests"]
