"""ctypes binding to the repository's host IO library
(``native/instancediff_io.cc``; port of ``instancediff_tpu/data/native_io.py``).

The library is built from that source by ``g++`` at first use into the
ignored ``instancediff_torch/_build/`` and exposes
``read_batch(paths, per_item, modes, n_threads)``: float32
[len(paths), per_item] read by a thread pool with the per-modality
normalisation fused into the read (modes in ``MODES``). A failed build or a
failed read raises: there is no quiet NumPy fallback. The NumPy route
(``SpeckleMedDataset.__getitem__`` with ``loader.collate``) is its plain
version."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

MODES = {"affine": 0, "ct": 1, "cryo": 2, "raw": 3}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "instancediff_io.cc")
LIB_PATH = os.path.join(_PKG, "_build", "libinstancediff_io.so")
# native/Makefile's flags
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-lpthread"]

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The library, built first when it is missing or older than its source."""
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.isfile(LIB_PATH)
                    or os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE)):
                os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
                proc = subprocess.run(
                    [os.environ.get("CXX", "g++"), SOURCE, "-o", LIB_PATH + ".tmp",
                     *CXX_FLAGS], capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(f"building {SOURCE} failed (rc={proc.returncode}):\n"
                                       f"{proc.stderr}")
                os.replace(LIB_PATH + ".tmp", LIB_PATH)
            lib = ctypes.CDLL(LIB_PATH)
            lib.idf_read_batch.restype = ctypes.c_int
            lib.idf_read_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads. A query only: ``read_batch``
    still raises where it does not."""
    try:
        load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def mode_for(name: str) -> int:
    """Per-artifact-type normalisation mode (``med_dataset.normalize_pair``)."""
    if name == "scatter artifact in CT":
        return MODES["ct"]
    if name == "noise in cryo-EM image":
        return MODES["cryo"]
    return MODES["affine"]


def read_batch(paths, per_item: int, modes, n_threads: int = 4) -> np.ndarray:
    """Read ``len(paths)`` raw float32 files of ``per_item`` values each into
    one [N, per_item] array, normalised per ``modes``."""
    n = len(paths)
    if len(modes) != n:
        raise ValueError(f"{len(modes)} modes for {n} paths")
    out = np.empty((n, per_item), dtype=np.float32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    c_modes = (ctypes.c_int32 * n)(*modes)
    rc = load().idf_read_batch(c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               per_item, c_modes, n_threads)
    if rc != 0:  # -1: a file did not open, -2: a file was short
        raise OSError(f"native read_batch failed (rc={rc}) on one of {list(paths)}")
    return out
