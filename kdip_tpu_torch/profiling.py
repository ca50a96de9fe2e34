"""Profiling and timing harness (PyTorch port of `kdip_tpu/profiling.py`).

`trace` records a torch.profiler trace (CPU and, with a card, CUDA
activity) and writes it as a Chrome trace; `timeit` times on the host
clock and ends its timed region with `torch.cuda.synchronize()` and a
scalar read back, since CUDA launches return before the device is done.

`span(name)` marks a stretch of the program's host work (a sampler step,
a guided NFE, its UNet forward, vjp and solve, a blocking read of a
device result). The span recorder is off until a caller switches it on
with `record_spans(True)`; then each span appends a `SpanRecord` of
`time.perf_counter_ns()` at its enter and exit, and `take_spans()` hands
the list over. Nothing of it reaches the device: a span adds no launch,
no synchronisation and no read.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, List, NamedTuple, Optional

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


class SpanRecord(NamedTuple):
    """One recorded span. Times are `time.perf_counter_ns()`; `parent` and
    `request` index the list `take_spans` returns (-1: none). A request
    span (`span(name, request=True)`, one batched solve) is its own
    request; every span inside it carries its index."""
    name: str
    start_ns: int
    end_ns: Optional[int]       # None for a span still open when taken
    parent: int
    request: int


class _NoSpan:
    """What `span` returns while the recorder is off: one shared object
    that does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Recorder:
    """The spans of one recording: entered on `thread` alone, kept as
    [name, start_ns, end_ns, parent, request] lists, `open` the indices
    of the spans entered and not yet left."""
    __slots__ = ("thread", "records", "open")

    def __init__(self):
        self.thread = threading.get_ident()
        self.records: List[list] = []
        self.open: List[int] = []


class _Span:
    __slots__ = ("rec", "name", "request", "index")

    def __init__(self, rec: _Recorder, name: str, request: bool):
        self.rec, self.name, self.request = rec, name, request

    def __enter__(self):
        rec = self.rec
        if threading.get_ident() != rec.thread:
            self.index = -1         # another thread's work: not recorded
            return None
        i = len(rec.records)
        parent = rec.open[-1] if rec.open else -1
        request = i if self.request else (
            rec.records[parent][4] if parent >= 0 else -1)
        self.index = i
        rec.open.append(i)
        rec.records.append([self.name, time.perf_counter_ns(), None,
                            parent, request])
        return None

    def __exit__(self, *exc):
        if self.index >= 0:
            self.rec.records[self.index][2] = time.perf_counter_ns()
            self.rec.open.pop()
        return False


_NO_SPAN = _NoSpan()
_recording: Optional[_Recorder] = None   # the recorder while it is on
_kept: Optional[_Recorder] = None        # the last one, until taken


def span(name: str, request: bool = False):
    """A context manager marking the block as the span `name`; with
    `request`, the block is one request of the program's caller. While
    the recorder is off it is one shared object that does nothing."""
    rec = _recording
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, request)


def record_spans(on: bool) -> None:
    """Switches the span recorder on, with a new empty list that records
    the spans of the calling thread, or off, keeping the list for
    `take_spans`."""
    global _recording, _kept
    _recording = _Recorder() if on else None
    if on:
        _kept = _recording


def take_spans() -> List[SpanRecord]:
    """The spans of the last recording, in the order they were entered,
    and the recorder off; the list is given up (a second call returns
    [])."""
    global _kept
    rec, _kept = _kept, None
    record_spans(False)
    return [] if rec is None else [SpanRecord(*r) for r in rec.records]
