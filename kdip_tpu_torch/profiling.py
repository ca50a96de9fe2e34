"""Profiling and timing harness (PyTorch port of `kdip_tpu/profiling.py`).

`trace` records a torch.profiler trace (CPU and, with a card, CUDA
activity) and writes it as a Chrome trace; `timeit`, `samples_per_second`
and `scan_timeit` time on the host clock and end every timed region with
`torch.cuda.synchronize()` and a scalar read back, since CUDA launches
return before the device is done.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the block with torch.profiler and writes
    `logdir/trace.json` (chrome://tracing, Perfetto) when it ends. Yields
    the profiler, whose `key_averages()` and `events()` the caller may
    read after the block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for leaf in out:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


def _sync(out) -> None:
    """Waits for the device, then reads one element of out's first tensor
    back to the host."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t = _first_tensor(out)
    if t is not None and t.numel():
        float(t.reshape(-1)[0])


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 1,
           **kwargs) -> float:
    """Mean wall seconds per call of fn(*args, **kwargs) over `iters`
    back-to-back calls, after `warmup` calls, the device synchronised and
    read back at the end."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def scan_timeit(step_fn: Callable, x0, iters: int = 20) -> float:
    """Seconds per step of x <- step_fn(x), `iters` steps back to back with
    one synchronisation at the end, after one warm-up run of the same
    steps. `kdip_tpu`'s version times one compiled `lax.scan`, a single
    program; here every step's eager launches are issued from the host and
    counted in the time."""
    def run():
        x = x0
        for _ in range(iters):
            x = step_fn(x)
        return x

    _sync(run())
    t0 = time.perf_counter()
    _sync(run())
    return (time.perf_counter() - t0) / iters


def samples_per_second(sample_fn: Callable, batch: int, *args,
                       iters: int = 3, **kwargs) -> float:
    """End-to-end throughput of sample_fn(*args, **kwargs), which makes
    `batch` samples a call, after one warm-up call."""
    _sync(sample_fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = sample_fn(*args, **kwargs)
    _sync(out)
    return batch * iters / (time.perf_counter() - t0)
