"""Profiling: torch.profiler traces, region labels, step timing and device
memory.

Counterpart of ``mvd_tpu/utils/profiling.py``. ``trace`` writes a Chrome
trace (``chrome://tracing``, Perfetto) of the enclosed region; ``time_fn``
times a callable with CUDA events on the GPU (with a synchronize after the
last iteration) and with the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed region (CPU, and CUDA where available) into
    ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A labelled range inside a trace."""
    return torch.profiler.record_function(name)


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3, **kwargs) -> Dict[str, float]:
    """Mean seconds per call after ``warmup`` calls: CUDA events where a GPU
    is present, the host clock otherwise."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    if torch.cuda.is_available():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return {"mean_s": start.elapsed_time(end) / 1e3 / iters, "iters": iters}
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return {"mean_s": (time.perf_counter() - t0) / iters, "iters": iters}


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-GPU memory in GiB: in use now and the peak since the last reset."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gib": s.get("allocated_bytes.all.current", 0) / 2**30,
            "peak_bytes_gib": s.get("allocated_bytes.all.peak", 0) / 2**30,
        }
    return out
