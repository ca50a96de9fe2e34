"""The measured window, seen from the model: `Counted` wraps the program's
model as the model_apply that `build_posterior_sampler` takes, so each call
is one guided NFE (guidance I calls the model once; the vjp is its
backward). At each call the `Clock` counts the NFE and, once the window's
seconds have passed, synchronises and raises `WindowClosed`, which ends
the window at an NFE boundary. `Capture` keeps the model's inputs and
outputs of the calls that the check compares."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Set

import torch


class WindowClosed(Exception):
    """Raised at an NFE boundary once the window's time is up."""


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Counts guided NFEs. Outside the window (warm-up) it raises
    WindowClosed after `stop_after` calls where that is set. With
    `sync_each` (the traced run) it synchronises at every boundary but
    those before the NFEs in `free` (the profiled slice's, which run as
    the untraced window does) and records it; `hooks[n]` runs at the
    boundary before the window's NFE n (0-based), after the boundary's
    time is read."""

    def __init__(self, device, seconds: float, sync_each: bool = False):
        self.device, self.seconds, self.sync_each = device, seconds, sync_each
        self.t0: Optional[float] = None
        self.t_end: Optional[float] = None
        self.nfes = 0                 # NFEs started in the window
        self.stop_after: Optional[int] = None
        self.calls = 0                # calls outside the window
        self.hooks: Dict[int, Callable] = {}
        self.free: Set[int] = set()
        self.arrive: List[float] = []  # the boundary before NFE n (synced)
        self.leave: List[float] = []   # the start of NFE n

    def open(self) -> None:
        sync(self.device)
        self.t0 = time.perf_counter()

    def boundary(self) -> None:
        if self.t0 is None:
            self.calls += 1
            if self.stop_after is not None and self.calls > self.stop_after:
                raise WindowClosed
            return
        synced = self.sync_each and self.nfes not in self.free
        if synced:
            sync(self.device)
        now = time.perf_counter()
        if now - self.t0 >= self.seconds:
            if not synced:
                sync(self.device)
                now = time.perf_counter()
            self.close(now)
            raise WindowClosed
        self.arrive.append(now)
        hook = self.hooks.pop(self.nfes, None)
        if hook is not None:
            hook()
            now = time.perf_counter()
        self.leave.append(now)
        self.nfes += 1

    def close(self, now: Optional[float] = None) -> None:
        """Ends the window (already synchronised, or now)."""
        if self.t_end is None:
            if now is None:
                sync(self.device)
                now = time.perf_counter()
            self.t_end = now

    def nfe_seconds(self, skip: Set[int]) -> List[float]:
        """Each NFE's wall time (sync_each only), but those in `skip`: from
        its start to the next boundary, the last one's to the close."""
        ends = self.arrive[1:] + [self.t_end]
        return [ends[n] - self.leave[n]
                for n in range(len(self.leave)) if n not in skip]


class Capture:
    """Clones the model's input and output at the chosen calls (indices
    within a solve) of one solve; `keep_out` marks the calls whose outputs
    are kept too."""

    def __init__(self, solve: int, calls: Set[int], keep_out: Set[int]):
        self.solve, self.calls, self.keep_out = solve, calls, keep_out
        self.current = -1
        self.call = 0
        self.x: Dict[int, torch.Tensor] = {}
        self.out: Dict[int, object] = {}

    def begin(self, solve: int) -> None:
        self.current, self.call = solve, 0

    def take(self, x, out) -> None:
        if self.current == self.solve and self.call in self.calls:
            self.x[self.call] = x.detach().clone()
            if self.call in self.keep_out:
                self.out[self.call] = (
                    tuple(o.detach().clone() for o in out)
                    if isinstance(out, tuple) else out.detach().clone())
        self.call += 1


class Counted:
    """model_apply for the sampler: the Clock's boundary, the model, the
    capture."""

    def __init__(self, model, clock: Clock, capture: Capture):
        self.model, self.clock, self.capture = model, clock, capture

    def __call__(self, x, t):
        self.clock.boundary()
        out = self.model(x, t)
        self.capture.take(x, out)
        return out
