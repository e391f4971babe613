"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` alone (no PyTorch headers) into ``instancediff_torch/_build/``,
then loaded with ``ctypes``. Nothing here runs at import time."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry points: name -> (argtypes, restype)
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "fused_gn_silu_conv3x3": {
        # x, scale, shift, packed w, bias, residual|NULL, out, B, H, W, C, Cout,
        # th, nb, stages, stream
        "fgc_tc_forward": ([_VP] * 7 + [_I] * 8 + [_VP], _I),
        # x, scale, shift, w, bias, residual|NULL, out, B, H, W, C, Cout, stream
        "fgc_fma_forward": ([_VP] * 7 + [_I] * 5 + [_VP], _I),
        # th, nb, stages
        "fgc_tc_smem_bytes": ([_I] * 3, _I),
    },
    "flash_attention": {
        # q, k, v, out, BH, N, Nk, D, scale, dtype, stream
        "flash_forward": ([_VP] * 4 + [_I] * 4 + [_F, _I, _VP], _I),
    },
    "group_norm_silu": {
        # x, gamma, beta, out, partials, gstat, tickets, B, HW, C, G, eps, silu,
        # dtype, vec, rows, cluster, stream
        "gns_forward": ([_VP] * 7 + [_I] * 4 + [_F] + [_I] * 5 + [_VP], _I),
        # x, gamma, beta, scale_shift, partials, tickets, B, HW, C, G, eps, dtype,
        # vec, rows, stream
        "gns_affine": ([_VP] * 6 + [_I] * 4 + [_F] + [_I] * 3 + [_VP], _I),
        # kind, C, G, vec, rows, tsize
        "gns_smem_bytes": ([_I] * 6, _I),
    },
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def start_build(name: str) -> subprocess.Popen | None:
    """Start ``nvcc`` for one kernel source; None when the library is already
    newer than its source. The output is written to a temporary name and
    moved into place by :func:`finish_build`."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = _lib_path(name)
    if os.path.isfile(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out + ".tmp", src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def finish_build(name: str, proc: subprocess.Popen | None) -> str:
    """Wait for a build started by :func:`start_build`; return nvcc's output
    (ptxas register/shared-memory report). Raises on a failed build."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n{log}")
    os.replace(_lib_path(name) + ".tmp", _lib_path(name))
    return log


def build_all(names=tuple(SIGNATURES)) -> dict:
    """Build every kernel in parallel (one nvcc each); name -> nvcc output."""
    procs = {n: start_build(n) for n in names}
    return {n: finish_build(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = _libs.get(name)  # loaded: no lock needed on every launch
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            finish_build(name, start_build(name))
            lib = ctypes.CDLL(_lib_path(name))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
