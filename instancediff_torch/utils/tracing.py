"""Step timing, profiling and device memory (port of
``instancediff_tpu/utils/tracing.py``, with JAX's names and summary keys).

- ``StepTimer``: wall-clock step statistics with the first ``warmup`` steps
  (the capture of the compiled sampler, the kernels' first launches) kept
  apart. It reads the host clock only: the caller synchronises the device
  inside each step (``torch.cuda.synchronize()``), as JAX's caller blocks on
  its result.
- ``trace(log_dir)``: ``torch.profiler`` over the CPU and, where present,
  CUDA, exported as a Chrome trace (``trace.json``) into ``log_dir``. It
  records the hand-written kernels by their CUDA names (``fgc_tc_kernel``,
  ``flash_tc_kernel``, ``gns_affine_kernel``, ...), launched eagerly or
  replayed in a CUDA graph.
- ``annotate(name)``: a ``record_function`` range in the trace, and an NVTX
  range when CUDA is present.
- ``device_memory_stats()``: per CUDA device, bytes in use, peak and limit;
  empty on the CPU, as JAX's where the backend has no statistics."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


class StepTimer:
    """Per-step wall-clock times (``with timer: step()``); the first
    ``warmup`` steps are kept apart."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self.warmup_times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if len(self.warmup_times) < self.warmup:
            self.warmup_times.append(dt)
        else:
            self.times.append(dt)
        return False

    def summary(self) -> Dict[str, float]:
        arr = np.asarray(self.times) if self.times else np.asarray([0.0])
        return {
            "steps": len(self.times),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "min_s": float(arr.min()),
            "warmup_s": float(sum(self.warmup_times)),
        }

    def message(self) -> str:
        s = self.summary()
        return (f"steps={s['steps']} mean={s['mean_s']*1000:.1f}ms "
                f"p50={s['p50_s']*1000:.1f}ms p95={s['p95_s']*1000:.1f}ms "
                f"(warmup {s['warmup_s']:.1f}s)")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work (CPU ops, and CUDA kernels where a card is
    present) and write it as a Chrome trace, ``log_dir/trace.json`` (open in
    Perfetto or chrome://tracing). The device is synchronised before the
    profiler stops, so every kernel the work launched has run."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Label the enclosed host work ``name`` in an active trace (and as an
    NVTX range when CUDA is present)."""
    from torch.profiler import record_function

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{``cuda:i``: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for each
    CUDA device (the caching allocator's allocated and peak bytes, and the
    device's total memory); {} without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
    return out
