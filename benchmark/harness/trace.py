"""The device trace of a run's traced slice: torch.profiler with CUDA
activity alone (CUPTI) around a stretch of NFEs. The profiler records no
host op, but CUPTI still costs the host some microseconds a launch, so
the slice runs slower than the untraced window (the `device_idle_share`
metric takes its denominator from the untraced NFEs for that). From the
trace: the busy time (the union of device intervals), the idle gaps named
by the device work on either side of them, the device time by kind, and
each kernel's time and launches.

The lead-in kernels and the spin-kernel marker follow chip_smoke.py's
`trace_device_events`: a trace can lose the records of its first kernels,
so small kernels run first and a spin kernel marks where the slice
begins."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

LEAD_IN_KERNELS = 200
# a kernel's kind by a part of its name, the first match winning
# ("winograd" before "conv", which would swallow it; a device-to-host copy
# is the host reading a result, as the CG does each iteration)
KERNEL_KINDS = (("haar_dwt", ("haar_dwt2",)),
                ("winograd", ("winograd_f23",)),
                ("layout", ("nchwToNhwc", "nhwcToNchw")),
                ("conv_gemm", ("xmma", "cutlass", "gemm", "conv", "sm90_")),
                ("reduction", ("reduce_kernel", "reduce")),
                ("host_read", ("DtoH", "Device -> Host")),
                ("memcpy_memset", ("Memcpy", "Memset")),
                ("fft", ("fft",)),
                ("elementwise", ("elementwise", "copy_kernel", "Functor")))

Span = Tuple[str, float, float]   # (name, start us, end us)


def kind_of(name: str) -> str:
    return next((k for k, parts in KERNEL_KINDS
                 if any(p in name for p in parts)), "other")


@dataclass
class Trace:
    device: List[Span]      # in start order, after the marker
    start_us: float         # the marker's end
    end_us: float           # the last device event's end

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some device event ran (a union)."""
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def gaps(self) -> List[Tuple[float, float, str, str]]:
        """The idle intervals of the slice (us), each with the kinds of the
        device work that ended before it and that ends it."""
        out, t, before = [], self.start_us, "slice start"
        for name, s, e in self.device:
            if s > t:
                out.append((t, s, before, kind_of(name)))
            if e >= t:
                t, before = e, kind_of(name)
        return out

    def idle_by_neighbours(self, top: int = 10):
        """[["<kind before> -> <kind after>", idle seconds]], summed over
        the gaps, longest first: what the device had finished when the
        host left it idle, and what the host launched next."""
        acc = {}
        for s, e, before, after in self.gaps():
            key = f"{before} -> {after}"
            acc[key] = acc.get(key, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:top]

    def seconds_by_kind(self, top: int = 10):
        acc = {}
        for name, s, e in self.device:
            kind = kind_of(name)
            acc[kind] = acc.get(kind, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:top]

    def kernel_seconds(self, part: str) -> float:
        return sum(e - s for n, s, e in self.device if part in n) / 1e6

    def kernel_launches(self, part: str) -> int:
        return sum(1 for n, _, _ in self.device if part in n)


class Tracer:
    """Starts and stops one torch.profiler trace (CUDA activity only) at
    NFE boundaries."""

    def __init__(self):
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        lead = torch.zeros(1, device="cuda")
        for _ in range(LEAD_IN_KERNELS):
            lead.add_(1)
        torch.cuda._sleep(1000)

    def stop(self):
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def _device_spans(self) -> List[Span]:
        """Every device event of the trace (us), in start order; from the
        profiler's raw events, which skips building its event tree."""
        from torch.autograd import DeviceType
        try:
            raw = self.prof.profiler.kineto_results.events()
            spans = [(e.name(), e.start_ns() / 1e3,
                      (e.start_ns() + e.duration_ns()) / 1e3)
                     for e in raw if e.device_type() == DeviceType.CUDA]
        except AttributeError:
            spans = [(e.name, e.time_range.start, e.time_range.end)
                     for e in self.prof.events()
                     if e.device_type == DeviceType.CUDA]
        return sorted(spans, key=lambda s: s[1])

    def read(self) -> Optional[Trace]:
        """The slice's trace, or None where the trace lost its marker or
        holds no device event after it."""
        if self.prof is None:
            return None
        dev = self._device_spans()
        marks = [j for j, s in enumerate(dev) if "spin_kernel" in s[0]]
        if not marks or marks[0] + 1 >= len(dev):
            return None
        start = dev[marks[0]][2]
        dev = dev[marks[0] + 1:]
        return Trace(dev, start, max(e for _, _, e in dev))
