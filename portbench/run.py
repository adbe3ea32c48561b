"""Run one cell of the benchmark of ``voicemap_tpu_torch`` once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks for.
The cell is looked up by name in ``BENCHMARK.json``; its configuration file,
its traffic mix (``portbench/traffic/<mix>.json``, whose ``kind`` names a
module of ``portbench/kinds/``), its limits (``portbench/workloads/<cell>.json``)
and each per-layer metric (``portbench/metrics/<metric>.py``) are found by
name, so a new cell, mix or metric is new files and entries only.

A run: find the card or fail; set up from the seed and warm the cell's
shapes (``setup_s``, from process start); then either measure for
``--seconds`` (``--trace 0``: the end-to-end metrics) or profile a window of
the mix's ``trace_seconds`` (``--trace 1``: the per-layer metrics, the
device's busy time and a breakdown); free the program's state; compare what
the timed path produced with the plain reference; print each number compared
beside its limit as the last lines of standard error, and one JSON line last
on standard output. ``--variant`` runs a control (``int8``: the program's own
int8 path) or plants a fault (``faults.py``); the benchmark's runs use none.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voicemap_tpu")  # compared with whole top-level names
VARIANTS = ("", "int8", "frozen_state", "half_batch", "altered_answer")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(items: list, name: str, what: str) -> dict:
    found = [x for x in items if x["name"] == name]
    if len(found) != 1:
        raise SystemExit(f"portbench: {what} {name!r} is not in BENCHMARK.json")
    return found[0]


def applies(metric: dict, cell: str, cell_e2e: set) -> bool:
    """A per-layer metric is the cell's where its ``workloads`` name the
    cell, or, with no such key, where the cell reports the end-to-end metric
    it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in cell_e2e


def load_metric(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--variant", choices=VARIANTS, default="")
    return p.parse_args(argv)


def main(argv=None, root: Path = ROOT, device: str = None) -> int:
    """``device`` is for the CPU tests alone: they pass ``"cpu"`` and skip
    the look for a card."""
    args = parse(argv)
    # One CPU thread: the default pool's threads spin after each small CPU
    # copy of the request path and take the core the host's launches need.
    torch.set_num_threads(1)
    if device is None and not torch.cuda.is_available():
        print("portbench: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    bench = load_json(root / "BENCHMARK.json")
    cell = by_name(bench["workloads"], args.workload, "workload")
    if device is None and torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device(device or "cuda")
    config = load_json(root / by_name(bench["configs"], cell["config"], "config")["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "portbench" / "workloads" / f"{cell['name']}.json")["limits"]

    from . import kinds
    if args.variant not in ("", "int8"):
        from . import faults
        faults.plant(args.variant)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    job = kind.Job(kinds.Context(config, traffic, args.seed, dev, args.variant))

    job.set_up()
    kinds.synchronize(dev)
    setup_s = time.perf_counter() - T_START
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    e2e_names = {m["name"] for m in bench["end_to_end"]
                 if cell["name"] in m.get("workloads", [cell["name"]])}
    result = {}
    if args.trace:
        from . import trace
        with trace.traced(dev) as box:
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                job.window(float(traffic["trace_seconds"]))
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        t = trace.read(box[0], job.work(), config, traffic)
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, cell["name"], e2e_names):
                value = load_metric(root, m["name"]).read(t)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": t.busy_s, "window_s": t.window_s}
        result["breakdown"] = trace.breakdown(t)
    else:
        window_s = job.window(args.seconds)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        values = {**job.end_to_end(window_s), "peak_gb": peak / 1e9, "setup_s": setup_s}
        metrics = {}
        for m in bench["end_to_end"]:
            if m["name"] in e2e_names:
                if m["name"] not in values:
                    raise SystemExit(f"portbench: the {traffic['kind']} kind does not "
                                     f"measure {m['name']}")
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        extra = {}
    work = job.work()

    job.release()
    numbers = job.check()
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in limits.items()}
    correct = work["failed"] == 0 and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    found = forbidden_modules()
    if found:
        print(f"portbench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    result = {
        "correct": correct, "attempted": work["attempted"], "failed": work["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": cell["chips"], "memory_peak_bytes": int(peak), **extra},
        **result,
        "checks": checks,
    }
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
