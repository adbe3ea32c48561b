"""The train step's optimizer (``train.steps._update`` around
``train.state.apply_updates``: the gradient clip and Adam): device
milliseconds of the program's ``optimizer`` spans (CUDA events at their
edges) a ``train_step`` span, in the traced window; None where the program
has no such spans."""

PHASE = "optimizer"


def read(t):
    try:
        from voicemap_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    records = spans()
    steps = sum(r.name == "train_step" for r in records)
    ms = [r.ms for r in records if r.name == PHASE and r.ms is not None]
    if steps == 0 or not ms:
        return None
    return sum(ms) / steps
