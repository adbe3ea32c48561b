"""The port's spans (``voicemap_tpu_torch/utils/profiling.span``) on the CPU.

Without a profiler a span is one shared null context and records nothing.
Under a CPU ``torch.profiler`` its ``voicemap.*`` name is on the profiler's
timeline, nested as the calls nest, and its record holds the enclosing span
and the rows. Each kind of benchmark cell, traced at a tiny size, leaves the
spans that the span-reading per-layer metrics read, and those metrics read
a number. The cells run in a child process: the benchmark refuses a process
that has JAX loaded, as this one has.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voicemap_tpu_torch.utils import profiling
from voicemap_tpu_torch.utils.profiling import clear_spans, span, spans

REPO = Path(__file__).resolve().parent.parent
CELLS = ("classifier_baseline.embed_bulk", "dilated_4khz.embed_bulk",
         "classifier_baseline.train_b2048", "classifier_baseline.request_b1")
SPAN_METRICS = {"classifier_baseline.embed_bulk": ["blockn_worst_roofline.embed"],
                "dilated_4khz.embed_bulk": ["blockn_worst_roofline.embed"],
                "classifier_baseline.train_b2048": ["forward_ms.train", "backward_ms.train",
                                                    "optimizer_ms.train"],
                "classifier_baseline.request_b1": ["host_ms.request"]}

# Each cell traced once at the benchmark CPU tests' tiny size, then one
# untraced run: the result lines and the span records, as one JSON line.
CHILD = r"""
import contextlib, io, json, sys, types
from pathlib import Path
from portbench.tests.conftest import make_tiny_root, run_cell
from voicemap_tpu_torch.utils import profiling

class Capsys:  # what run_cell reads of pytest's capsys
    def __init__(self, buf):
        self.buf = buf
    def readouterr(self):
        out = self.buf.getvalue()
        self.buf.seek(0)
        self.buf.truncate()
        return types.SimpleNamespace(out=out, err="")

root = make_tiny_root(Path(sys.argv[1]))
def run(cell, trace):
    profiling.clear_spans()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = run_cell(root, cell, trace=trace, capsys=Capsys(buf))
    return {"result": result,
            "records": [[r.name, r.parent, r.rows, r.ms] for r in profiling.spans()]}
out = {cell: run(cell, 1) for cell in sys.argv[2:]}
out["untraced"] = run(sys.argv[2], 0)
print(json.dumps(out))
"""


@pytest.fixture(autouse=True)
def no_records():
    clear_spans()
    yield
    clear_spans()


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    first, second = span("embed", 4), span("head")
    assert first is second
    with first:
        with second:
            torch.ones(2).add_(1)
    assert spans() == []


def test_spans_under_a_cpu_profiler_nest_with_their_parent_and_rows():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", 4):
            with span("inner", 2):
                torch.ones(64).exp_()
            with span("inner2"):
                torch.ones(64).sin_()
    records = spans()
    assert [(r.name, r.parent, r.rows) for r in records] == [
        ("outer", None, 4), ("inner", "outer", 2), ("inner2", "outer", None)]
    assert all(r.ms is not None and r.ms >= 0 for r in records)
    assert records[1].ms + records[2].ms <= records[0].ms
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("voicemap.")}
    assert set(ranges) == {"voicemap.outer", "voicemap.inner", "voicemap.inner2"}
    outer = ranges["voicemap.outer"]
    for name in ("voicemap.inner", "voicemap.inner2"):
        assert outer.start <= ranges[name].start <= ranges[name].end <= outer.end
    assert ranges["voicemap.inner"].end <= ranges["voicemap.inner2"].start
    with span("after"):  # the profiler has stopped: nothing more is recorded
        pass
    assert len(spans()) == 3
    clear_spans()
    assert spans() == []


class FakeEvent:
    """A CUDA event as the span uses it, for the CPU: ``record`` logs, and
    the event has finished once ``FakeEvent.done`` is set."""

    log: list = []
    done = False
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        FakeEvent.clock += 1.0
        self.at = FakeEvent.clock
        FakeEvent.log.append("record")

    def query(self):
        return FakeEvent.done

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


class FakeScope:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        FakeEvent.log.append("enter " + self.name)

    def __exit__(self, *exc):
        FakeEvent.log.append("exit " + self.name)


@pytest.fixture
def fake_card(monkeypatch):
    """The span's card path on fake events, under a CPU profiler."""
    FakeEvent.log, FakeEvent.done, FakeEvent.clock = [], False, 0.0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch, "Event", FakeEvent)
    with profile(activities=[ProfilerActivity.CPU]):
        yield monkeypatch


def test_a_spans_events_lie_outside_its_host_scope(fake_card):
    fake_card.setattr(torch._C._profiler, "_RecordFunctionFast", FakeScope)
    with span("embed", 2):
        with span("head", 2):
            FakeEvent.log.append("work")
    assert FakeEvent.log == ["record", "enter voicemap.embed", "record", "enter voicemap.head",
                             "work", "exit voicemap.head", "record", "exit voicemap.embed",
                             "record"]
    assert [(r.name, r.parent, r.ms) for r in spans()] == [("embed", None, 3.0),
                                                           ("head", "embed", 1.0)]


def test_a_long_trace_keeps_no_more_unresolved_events_than_the_cap(fake_card):
    fake_card.setattr(profiling, "PENDING_EVENTS_CAP", 8)
    for _ in range(7):
        with span("train_step", 4):
            pass
    assert all(r.events is not None for r in profiling._records)
    FakeEvent.done = True  # the device has caught up
    with span("train_step", 4):
        pass
    kept = [r for r in profiling._records if r.events is not None]
    assert kept == [] and len(profiling._pending) == 0
    FakeEvent.done = False  # none finished: every one stays until read
    for _ in range(10):
        with span("forward", 4):
            pass
    assert len(profiling._pending) == 10
    records = spans()
    assert [r.ms for r in records] == [1.0] * 18 and profiling._pending == []


def test_the_profile_trace_carries_the_spans_and_drops_their_records(tmp_path):
    with profiling.trace(str(tmp_path)):
        with span("train_step", 8):
            torch.ones(8).mul_(2)
        assert [r.name for r in spans()] == ["train_step"]
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert "voicemap.train_step" in names
    assert spans() == []


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_bench")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(root), *CELLS], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_traced_cell_reads_its_span_metrics(tiny_runs, cell):
    run = tiny_runs[cell]
    result, records = run["result"], run["records"]
    assert result["correct"]
    for name in SPAN_METRICS[cell]:
        value = result["metrics"][name]["value"]
        assert value is not None and value > 0, name
    assert all(ms is not None and ms >= 0 for *_, ms in records)
    parents = {(name, parent) for name, parent, _, _ in records}
    rows = {name: set() for name, *_ in records}
    for name, _, r, _ in records:
        rows[name].add(r)
    if cell.endswith("embed_bulk"):
        blocks = 4 if cell.startswith("classifier") else 8
        want = ({("embed_rows", None), ("fetch_batch", "embed_rows"), ("embed", "embed_rows"),
                 ("block0", "embed"), ("head", "embed")}
                | {(f"blockn.{i}", "embed") for i in range(1, blocks)})
        assert parents == want
        assert rows["embed_rows"] == {24} and rows["blockn.1"] == {8}
    elif cell.endswith("train_b2048"):
        assert parents == {("train_step", None), ("fetch_batch", "train_step"),
                           ("forward", "train_step"), ("backward", "train_step"),
                           ("optimizer", "train_step")}
        assert all(r == {8} for r in rows.values())
        steps = sum(name == "train_step" for name, *_ in records)
        assert steps == result["attempted"]
        phases = sum(result["metrics"][m]["value"] for m in SPAN_METRICS[cell])
        assert phases <= result["device"]["window_s"] * 1e3 / steps
    else:
        assert parents == {("host_to_device", None), ("preprocess", None), ("embed", None),
                           ("block0", "embed"), ("blockn.1", "embed"), ("blockn.2", "embed"),
                           ("blockn.3", "embed"), ("head", "embed"), ("nshot_predict", None)}
        assert all(r == {1} for r in rows.values())
        requests = result["attempted"]
        assert sum(name == "nshot_predict" for name, *_ in records) == requests
        assert result["metrics"]["host_ms.request"]["value"] <= (
            result["device"]["window_s"] * 1e3 / requests)


def test_an_untraced_run_records_no_span(tiny_runs):
    run = tiny_runs["untraced"]
    assert run["result"]["correct"] and run["records"] == []
