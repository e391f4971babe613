"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` alone (no PyTorch headers) into ``instancediff_torch/_build/``,
then loaded with ``ctypes``. Nothing here runs at import time.

Each library links the CUDA runtime statically (nvcc's default), so it has
a runtime of its own beside PyTorch's. Both use the same device context,
and stream capture belongs to the stream itself, below either runtime, so
a launch a library issues on PyTorch's capturing stream is captured like
PyTorch's own; only first-call work (loading a library, a kernel's first
launch, the shared-memory limits) has to happen before the capture."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

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
        # q, k, v, out, BH, N, Nk, D, scale, dtype, path, stream
        "flash_forward": ([_VP] * 4 + [_I] * 4 + [_F, _I, _I, _VP], _I),
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
    """The loaded kernel library, built first if needed. Not while a CUDA
    graph is being captured: loading registers the library's kernels with
    its CUDA runtime, which is first-call work for a warm-up to do."""
    lib = _libs.get(name)  # loaded: no lock needed on every launch
    if lib is not None:
        return lib
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"kernel library {name} first loaded during a CUDA graph "
                           "capture; run one step eagerly on the capture stream first")
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


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when a kernel's caller asks for gradients: a kernel's output is
    filled through ``ctypes`` and has no autograd history, so everything
    upstream of it and every weight it reads would silently get none. The
    differentiable path is the nets' ``plain=True`` forward, which the
    engines' ``optimize_parameters`` runs (no kernel there); sampling runs
    under ``torch.inference_mode``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input requires grad; "
            "train through the differentiable plain path (the UNet's forward with "
            "plain=True, as engine.optimize_parameters runs it), or call the kernel "
            "under torch.no_grad() / torch.inference_mode()")


def count_launch(wrapper) -> None:
    """Count one call of ``wrapper`` into its kernel library. Outside a CUDA
    graph capture the call launched its kernel: ``wrapper.launches`` += 1.
    Under capture it only recorded the kernel into the graph:
    ``wrapper.captured`` += 1, and the graph's owner adds the captured counts
    to ``launches`` at every replay (``models/engine.py:CompiledStep``), so
    ``launches`` counts the kernels the device ran either way."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1
