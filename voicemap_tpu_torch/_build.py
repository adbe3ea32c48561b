"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared library
with a plain C interface, which ``ctypes`` loads. The
library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once. Nothing is built at import time:
the first kernel launch builds.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes. Each returns its cudaError_t as an int.
SIGNATURES = {
    # store, n_rows, row_len, idx, off, out, B, frag, rms, eps, whiten, stream
    "vm_gather_whiten": (_P, _L, _L, _P, _P, _P, _I, _I, _F, _F, _I, _P),
    # x, w, aff, inv_s0 (NULL unless int8 out), out, B, T, C, K, pool,
    # round_x_bf16, out_bf16, stream
    "vm_conv_block0": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, wp, aff, inv_s0 (NULL unless int8 out), out, B, T, C, out_kind, tile, stream
    "vm_conv_block0_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, aff, out, B, T, Cin, Cout, dilation, pool, out_kind, stream
    "vm_quant_block": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, w, aff, out, B, T, Cin, Cout, stage, stream
    "vm_quant_block_stage": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, aff (rows s, b), out, B, T, Cin, Cout, dilation, out_kind, stream
    "vm_quant_block_train": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w, aff, out, B, T, Cin, Cout, k, dilation, pool, out_kind, stream
    "vm_conv_blockn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, w, w_stride_k, w_stride_c, bias, sgn, sel, part, stats, B, T, C, tile,
    # n_cps, sel_bf16, gemm_f32, stream
    "vm_block0_train_tc_fwd": (_P, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _P),
    # x, w, w_stride_k, w_stride_c, bias, sgn, c0, c1, c2, g, part, out,
    # sel (NULL unless staged), route (likewise), B, T, C, tile, n_cps,
    # gemm_f32, stream
    "vm_block0_train_tc_bwd": (_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _P),
    # z, bias, sgn, sel, idx (NULL: no index), part, stats, B, C, T, pool, vec,
    # strips, span, a_bf16, sel_bf16, stream
    "vm_pool_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # z, bias, a_sel (or idx), g, c0, c1, c2, dz, part, db, B, C, T, pool, vec,
    # strips, span, a_bf16, out_bf16, by_idx, stream
    "vm_route_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _P),
    # sel, mu, scale, beta, mask (NULL: no dropout), inv_keep, y, B, C, T', vec,
    # strips, span, sel_dt, out_dt (0 f32, 1 bf16, 2 f16), stream
    "vm_bn_apply": (_P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # g, sel, mask (NULL: no dropout), inv_keep, mu, r, gout, part, sums, B, C,
    # T', vec, strips, span, g_dt, sel_dt (as vm_bn_apply's), stream
    "vm_bn_grad": (_P, _P, _P, _F, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, frag, offs, weights, bands, out, B, T, n_frames, ksteps, hop, M, n_passes,
    # n_weights, log_eps, stream
    "vm_log_mel_tc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # x, tables, weights, bands, out, B, T, n_frames, win, hop, M, n_weights,
    # log_nc, log_eps, stream
    "vm_log_mel_fft": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, s, w, b, out, T, nq, ns, D, stream
    "vm_weighted_l1": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # h, logits (NULL: unweighted), mean, std, B, T, C, ld, bf16, eps, stream
    "vm_asp_stats": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # h, logits, mean, std, max, sum, B, T, C, ld, bf16, eps, stream
    "vm_asp_stats_train": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # h, logits (NULL: unweighted), mean, std, max, sum, g_mean, g_std, dh,
    # dlogits, B, T, C, ld, ld_g, bf16, eps, stream
    "vm_asp_stats_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # x, dz, part, dw, B, T, Cin, Cout, k, dilation, splits, stream
    "vm_conv_wgrad": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "voicemap_tpu_torch need the CUDA toolkit to build"
    )


def build() -> tuple[Path, float, str]:
    """Compile the kernels if no library for these sources exists yet.

    Returns ``(library path, build seconds, ptxas report)``; the seconds are
    0 and the report empty when the library was already built.
    """
    target = BUILD_DIR / f"libvoicemap_kernels_{_digest()}.so"
    if target.exists():
        return target, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Build in a private directory, then rename: concurrent builders never
    # load a half-written library.
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = work / f"{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        reports, failed = [], []
        for src, _, proc in jobs:  # wait for every compiler before raising
            out, err = proc.communicate()
            reports.append(err)
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = work / target.name
        link = subprocess.run([nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stderr}")
        os.replace(lib, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return target, time.perf_counter() - t0, "".join(reports)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with typed entry points."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.vm_error_string.argtypes = [ctypes.c_int]
    lib.vm_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().vm_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err} ({msg})")
