"""The plain reference against the port's CPU path at tiny sizes, and what it
may import."""

from __future__ import annotations

import ast
import json

import pytest
import torch

from portbench import data, program
from portbench.reference import conv1d_encoder as ref

from .conftest import REPO, make_tiny_root, run_cell

CELLS = ("classifier_baseline.embed_bulk", "dilated_4khz.embed_bulk",
         "classifier_baseline.train_b2048", "classifier_baseline.request_b1")


@pytest.mark.parametrize("cell", CELLS)
def test_float32_program_agrees_with_reference(tiny_root, capsys, cell):
    """The whole run at float32 compute: every number compared reads at
    rounding level, far under its limit."""
    res = run_cell(tiny_root, cell, capsys=capsys)
    assert res["correct"]
    assert all(c["value"] < 1e-5 for c in res["checks"].values()), res["checks"]


def test_embed_agrees_with_port_model():
    config = json.loads((REPO / "portbench/configs/dilated_4khz.json").read_text())
    config["encoder"].update(filters=8, compute_dtype="float32")
    config["data"]["seconds"] = 0.5
    cfg = program.experiment_config(config)
    model = program.classifier(cfg, config, 3, 5, "cpu")
    raw = torch.randint(-3000, 3000, (4, 8000), dtype=torch.int16)
    x = ref.preprocess(raw, config)
    with torch.no_grad():
        want = model.embed(x.transpose(1, 2))
    got = ref.embed(data.weights(config, 3, 5, "cpu"), x, config)
    assert float(ref.relative_errors(got, want).max()) < 1e-5  # rounding of f32 sums


def test_bfloat16_program_reads_above_rounding(tmp_path, capsys):
    """At the configs' bf16 compute the numbers are those of bf16, not of
    f32: the comparison can tell the two apart."""
    root = make_tiny_root(tmp_path, compute_dtype="bfloat16")
    res = run_cell(root, "classifier_baseline.embed_bulk", capsys=capsys)
    assert res["checks"]["embed_err_max"]["value"] > 1e-3


def test_reference_imports_no_program():
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("torch", "math", "importlib", "__future__"), \
                    f"{path.name} imports {name}"
