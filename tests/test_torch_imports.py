"""The port stands without JAX, flax, pandas, matplotlib and the JAX package
(``voicemap_tpu``), imports nothing from outside itself, and chip_smoke.py
refuses to run where there is no GPU."""

import ast
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
SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "step_attrib.py"]


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_flax_pandas_blocked():
    """Every module of the port (the experiment CLIs among them),
    chip_smoke.py and step_attrib.py import with JAX, flax, pandas, the JAX
    package and matplotlib (which the card's machine lacks) blocked."""
    modules = list(_modules()) + ["chip_smoke", "step_attrib"]
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'pandas', 'voicemap_tpu', 'matplotlib'):\n"
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


# Scripts and harnesses at the repository root: they import the port, never
# the other way round.
OUTSIDE = {"chip_smoke", "step_attrib", "portbench", "benchmarks", "bench"}


def _is_sys_path(node: ast.expr) -> bool:
    """``sys.path``, or a slice or an element of it."""
    if isinstance(node, ast.Subscript):
        node = node.value
    return ast.unparse(node) == "sys.path"


def _reaches_outside(tree: ast.Module):
    """``(line, what)`` for each import of a name in OUTSIDE and each edit of
    ``sys.path`` in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            names = []
        for name in names:
            if name.split(".")[0] in OUTSIDE:
                yield node.lineno, f"imports {name}"
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("insert", "append", "extend")
                and _is_sys_path(node.func.value)):
            yield node.lineno, f"calls sys.path.{node.func.attr}"
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        else:
            targets = []
        if any(_is_sys_path(t) for t in targets):
            yield node.lineno, "assigns to sys.path"


def test_the_port_imports_nothing_outside_itself():
    """No module of the port imports a root script or the benchmark, or edits
    ``sys.path``: what it imports does not depend on the caller's working
    directory."""
    offenders = [f"{path.relative_to(REPO)}:{line} {what}"
                 for path in sorted(PACKAGE.rglob("*.py"))
                 for line, what in _reaches_outside(ast.parse(path.read_text()))]
    assert not offenders, offenders


def test_the_train_modules_are_covered():
    """The import test above reaches every module of the training port."""
    modules = set(_modules())
    for name in ("train.losses", "train.state", "train.metrics", "train.checkpoints",
                 "train.loop", "train.steps", "models.fused_train", "ops.conv_train",
                 "ops.cuda_conv_train", "ops.cuda_routing"):
        assert f"voicemap_tpu_torch.{name}" in modules, name


def test_the_mel_modules_are_covered():
    """The import tests reach every module of config #4's port and its
    kernel source is among the ones the build compiles."""
    from voicemap_tpu_torch import _build

    modules = set(_modules())
    for name in ("ops.melspec", "ops.cuda_melspec", "models.spectrogram"):
        assert f"voicemap_tpu_torch.{name}" in modules, name
    assert "log_mel.cu" in {p.name for p in _build.sources()}
    assert "tf32x3.cuh" in {p.name for p in _build.sources()}
    assert {"vm_log_mel_tc", "vm_log_mel_fft"} <= set(_build.SIGNATURES)


def test_the_siamese_modules_are_covered():
    """The import tests reach every module of config #2's port and B9's
    source is among the ones the build compiles."""
    from voicemap_tpu_torch import _build

    modules = set(_modules())
    for name in ("ops.cuda_distance", "ops.distance", "ops.sampling", "models.siamese",
                 "eval.verification", "eval.nshot", "models.fused_train", "train.steps"):
        assert f"voicemap_tpu_torch.{name}" in modules, name
    assert "weighted_l1.cu" in {p.name for p in _build.sources()}
    assert "vm_weighted_l1" in _build.SIGNATURES


def test_the_b8_and_b10_modules_are_covered():
    """The import tests reach the pooled-GEMM encoder and the attribution
    tool; B8's source is among the ones the build compiles, and both new
    entry points are bound."""
    from voicemap_tpu_torch import _build

    modules = set(_modules())
    for name in ("models.fused_encoder", "models.fast_infer", "ops.cuda_conv",
                 "ops.cuda_quant_block", "utils.qblock_attrib", "utils.stage_profile"):
        assert f"voicemap_tpu_torch.{name}" in modules, name
    assert "conv_blockn.cu" in {p.name for p in _build.sources()}
    assert {"vm_conv_blockn", "vm_quant_block_stage"} <= set(_build.SIGNATURES)


def test_the_data_layer_and_streaming_modules_are_covered():
    """The import tests reach every module of the pandas-free data layer and
    the streaming path, none of them imports jax, flax, pandas or
    voicemap_tpu, and the FLAC decoder's source is the port's own."""
    from voicemap_tpu_torch.data import flac_ext

    modules = set(_modules())
    new = ("data.audio", "data.flac_enc", "data.flac_ext", "data.synthetic", "data.index",
           "data.dataset", "data.preprocessing", "data.pipeline", "ops.preprocess",
           "train.steps", "train.loop", "eval.nshot", "models.quant_infer",
           "models.spectrogram")
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|pandas|voicemap_tpu)\b", re.M)
    for name in new:
        assert f"voicemap_tpu_torch.{name}" in modules, name
        path = PACKAGE.joinpath(*name.split(".")).with_suffix(".py")
        assert not banned.search(path.read_text()), name
    assert flac_ext.SOURCE.is_relative_to(PACKAGE) and flac_ext.SOURCE.exists()
    assert flac_ext.BUILD_DIR == REPO / "build" / "flac"


def test_the_protocol_and_cli_modules_are_covered():
    """The import tests reach the protocol, the key-stream replay, the sweep's
    module and the five experiment CLIs, and none of them imports matplotlib
    at module level."""
    modules = set(_modules())
    new = ("ops.jax_random", "eval.protocol", "eval.nshot", "train.checkpoints",
           "utils.profiling", "experiments", "experiments._train",
           "experiments.train_classifier", "experiments.train_siamese", "experiments.evaluate",
           "experiments.embed", "experiments.visualize_embeddings")
    top_level = re.compile(r"^(import|from)\s+matplotlib\b", re.M)
    for name in new:
        assert f"voicemap_tpu_torch.{name}" in modules, name
        parts = name.split(".")
        path = PACKAGE.joinpath(*parts).with_suffix(".py")
        if not path.exists():
            path = PACKAGE.joinpath(*parts, "__init__.py")
        assert not top_level.search(path.read_text()), name


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
    from voicemap_tpu_torch.utils import qblock_attrib, stage_profile

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert stage_profile.main([]) == 1
    assert qblock_attrib.main([]) == 1


def test_the_parallel_modules_are_covered():
    """The parallel layer (config #5 and data parallel) imports with JAX and
    the JAX package blocked, in a process of its own, and none of its
    modules names them; its five modules are among the ones the first test
    imports."""
    modules = set(_modules())
    new = ("parallel", "parallel.mesh", "parallel.distributed", "parallel.sharded_distance",
           "parallel.pod_eval", "parallel.data_parallel")
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|pandas|voicemap_tpu)\b", re.M)
    for name in new:
        assert f"voicemap_tpu_torch.{name}" in modules, name
        parts = name.split(".")
        path = PACKAGE.joinpath(*parts).with_suffix(".py")
        if not path.exists():
            path = PACKAGE.joinpath(*parts, "__init__.py")
        assert not banned.search(path.read_text()), name
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'voicemap_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {['voicemap_tpu_torch.' + n for n in new]!r}:\n"
        "    importlib.import_module(m)\n"
        "import voicemap_tpu_torch.train.loop as loop\n"
        "assert loop.use_data_parallel('on', 2, 8, 'cpu')\n"
        "print('imported')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_the_sequence_tensor_and_pipeline_modules_are_covered():
    """The halo-exchange, data × seq, tensor and pipeline parallel modules,
    their collectives and the dry run import with JAX and the JAX package
    blocked, in a process of their own, and none of them names them; the
    first test imports them too."""
    modules = set(_modules())
    new = ("parallel.comm", "parallel.halo_conv", "parallel.dp_sp", "parallel.tensor_parallel",
           "parallel.pipeline_parallel", "parallel.dryrun")
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|pandas|voicemap_tpu)\b", re.M)
    for name in new:
        assert f"voicemap_tpu_torch.{name}" in modules, name
        path = PACKAGE.joinpath(*name.split(".")).with_suffix(".py")
        assert not banned.search(path.read_text()), name
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'voicemap_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {['voicemap_tpu_torch.' + n for n in new]!r}:\n"
        "    importlib.import_module(m)\n"
        "from voicemap_tpu_torch.parallel import dryrun\n"
        "assert dryrun.main(['--n', '2']) == 1  # no card here: refused, nothing spawned\n"
        "print('imported')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
