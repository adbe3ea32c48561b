"""The port stands without JAX, flax, pandas and the JAX package
(``voicemap_tpu``), and chip_smoke.py refuses to run where there is no GPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "voicemap_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_flax_pandas_blocked():
    modules = list(_modules()) + ["chip_smoke"]
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'pandas', 'voicemap_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_the_train_modules_are_covered():
    """The import test above reaches every module of the training port."""
    modules = set(_modules())
    for name in ("train.losses", "train.state", "train.metrics", "train.checkpoints",
                 "train.loop", "train.steps", "models.fused_train", "ops.conv_train",
                 "ops.cuda_conv_train", "ops.cuda_routing"):
        assert f"voicemap_tpu_torch.{name}" in modules, name


def test_no_jax_flax_pandas_import_in_the_port():
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|pandas|voicemap_tpu)\b", re.M)
    offenders = [str(p.relative_to(REPO)) for p in SOURCES if banned.search(p.read_text())]
    assert len(SOURCES) > 20 and not offenders


def test_chip_smoke_exits_nonzero_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would drive the slice")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # Alone in a directory, without the package, it cannot run either.
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_timing_refuses_to_time_the_cpu():
    from voicemap_tpu_torch.utils.profiling import throughput, time_fn

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        time_fn(lambda: None)
    with pytest.raises(RuntimeError):
        throughput(lambda: None, items_per_call=1)


def test_profilers_refuse_to_run_without_a_gpu():
    from voicemap_tpu_torch.utils import stage_profile, train_profile

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert train_profile.main([]) == 1
    assert stage_profile.main([]) == 1
