"""The train step's forward (``train.steps.train_on_batch`` around the loss
function: the train forward and the loss): device milliseconds of the
program's ``forward`` spans (CUDA events at their edges) a ``train_step``
span, in the traced window; None where the program has no such spans."""

PHASE = "forward"


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
