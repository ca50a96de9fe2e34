"""The program's spans (the span recorder of `kdip_tpu_torch.profiling`)
against the device trace of a traced slice: what the host was doing while
the card idled.

The profiler stamps two kinds of record: the device's work (kernels,
copies) and, on the host, the CUDA runtime calls that issued it, joined
by a correlation id. Its host records are Unix-epoch ns; the spans are
`perf_counter_ns`. Its device records are the GPU's clock mapped onto the
host's, and on an H100 that mapping drifts (by up to ms a second) and
jumps (by ms): a device-to-host copy can be stamped milliseconds before
the runtime call that issued it. So the spans go onto the trace's host
clock with one pair of clock readings, and the device's records onto the
host clock by the device clock's offset, read off the trace itself.

- `clock_pair`, `on_trace_clock`: the spans in the trace's host us.
- `DeviceClock`: the offset (device clock minus host clock) at a device
  time t, as the least `start - call start + drift |t - start|` over the
  device's work within `window_us` either side. No work starts before its
  call, and work the host paced (the device idle, waiting for it) starts
  a few us after; the clock drifts at most `drift` us an us between, and
  a short window keeps a jump's reach short.
- `alignment` checks both clocks: every program device-to-host copy, on
  the host clock, lies inside a `guidance.host_read` span (the host
  blocks in it until the copy is done). Copies outside every request span
  are the caller's (the benchmark's finite check after each solve).
- `idle_by_span` splits each idle gap of the slice (`Trace.gaps`'s, on
  the host clock) among the innermost spans open during it: a span takes
  the overlap of its self-time (the time none of its children covers)
  with the gap; time with no span open is `outside`. The sums add up to
  the slice's idle time, window_s - busy_s.
- `per_nfe` gives the split's per-layer figures over the slice's NFEs.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

from harness import trace

HOST_READ = "guidance.host_read"
REQUEST = "sampling_api.sample"
OUTSIDE = "outside"
# the per-layer figures of the split: metric -> the span names it sums
LAYERS = {"fwd_idle_ms_per_nfe": ("guidance.forward",),
          "vjp_idle_ms_per_nfe": ("guidance.vjp",),
          "cg_idle_ms_per_nfe": ("guidance.solve", HOST_READ),
          "sampler_idle_ms_per_nfe": (REQUEST, "samplers.step",
                                      "samplers.noise")}

Interval = Tuple[float, float]


class Span(NamedTuple):
    """A program span on the trace's host clock (us); end None while
    open."""
    name: str
    start_us: float
    end_us: Optional[float]
    parent: int
    request: int


def clock_pair() -> Tuple[int, int]:
    """(perf_counter_ns, time_ns) read together: the host clock the spans
    are stamped with, and the profiler's."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, wall


def on_trace_clock(records: Iterable, pair: Tuple[int, int]) -> List[Span]:
    """The recorded spans (`profiling.SpanRecord`s) in the trace's us."""
    off = pair[1] - pair[0]
    return [Span(r.name, (r.start_ns + off) / 1e3,
                 None if r.end_ns is None else (r.end_ns + off) / 1e3,
                 r.parent, r.request) for r in records]


class DeviceClock:
    """The device clock's offset from the host clock along a trace:
    `calls[i]` is the host interval (us) of the runtime call that issued
    `t.device[i]`, or None."""

    def __init__(self, t: trace.Trace, calls: Sequence[Optional[Interval]],
                 window_us: float = 20_000.0, drift: float = 5e-3):
        pts = [(s - t.start_us, s - c[0])
               for (_, s, _), c in zip(t.device, calls) if c is not None]
        ts = [p[0] for p in pts]
        # min over j of lag_j + drift |t_i - t_j|: the j before i and the
        # j after i each a sliding minimum
        back = _window_min(ts, [v - drift * u for u, v in pts], window_us,
                           ahead=False)
        fwd = _window_min(ts, [v + drift * u for u, v in pts], window_us,
                          ahead=True)
        self.offsets = [min(b + drift * u, f - drift * u)
                        for u, b, f in zip(ts, back, fwd)]
        self.times = [u + t.start_us for u in ts]

    def offset(self, when: float) -> float:
        """The offset at the device time `when` (0 with no call on
        record)."""
        if not self.times:
            return 0.0
        i = bisect.bisect_left(self.times, when)
        if i == len(self.times) or (
                i > 0 and when - self.times[i - 1] < self.times[i] - when):
            i -= 1
        return self.offsets[i]

    def host(self, s: float, e: float) -> Interval:
        """A device interval on the host clock."""
        off = self.offset(s)
        return s - off, e - off


def _window_min(ts: List[float], vs: List[float], w: float,
                ahead: bool) -> List[float]:
    """For each i, the least vs[j] with ts[j] in [ts[i], ts[i] + w]
    (`ahead`) or in [ts[i] - w, ts[i]]; ts sorted."""
    n = len(ts)
    order = range(n - 1, -1, -1) if ahead else range(n)
    out, dq = [0.0] * n, collections.deque()
    for i in order:
        while dq and vs[dq[-1]] >= vs[i]:
            dq.pop()
        dq.append(i)
        while abs(ts[dq[0]] - ts[i]) > w:
            dq.popleft()
        out[i] = vs[dq[0]]
    return out


def host_gaps(t: trace.Trace, clock: DeviceClock) -> List[Interval]:
    """The slice's idle gaps on the host clock, in start order."""
    return sorted(clock.host(s, e) for s, e, _, _ in t.gaps())


def _excursion(s: float, e: float, spans: List[Span]) -> float:
    """How far (us) [s, e] reaches outside the nearest of `spans` (0:
    inside one)."""
    best = float("inf")
    for sp in spans:
        end = float("inf") if sp.end_us is None else sp.end_us
        best = min(best, max(sp.start_us - s, e - end, 0.0))
    return best


def alignment(t: trace.Trace, clock: DeviceClock, spans: List[Span]
              ) -> Dict:
    """The slice's device-to-host copies, on the host clock, against the
    read spans: `inside` of `reads` lie inside a `guidance.host_read`
    span, `worst_us` is the farthest any reaches out of its nearest read
    span; `callers` lie outside every request span (not counted in
    `reads`)."""
    reads = [sp for sp in spans if sp.name == HOST_READ]
    requests = [sp for sp in spans if sp.name == REQUEST]
    inside = total = callers = 0
    worst = 0.0
    for name, s, e in t.device:
        if trace.kind_of(name) != "host_read":
            continue
        s, e = clock.host(s, e)
        if requests and _excursion(s, e, requests) > 0:
            callers += 1
            continue
        total += 1
        x = _excursion(s, e, reads) if reads else float("inf")
        inside += x == 0
        worst = max(worst, x)
    return {"inside": inside, "reads": total, "worst_us": worst,
            "callers": callers}


def innermost(spans: List[Span], end_us: float) -> List[Tuple[float, float,
                                                               str]]:
    """The timeline as (start, end, name) pieces, in order, each under the
    innermost span open then (no piece where none is open); spans still
    open end at `end_us`."""
    events = []
    for i, sp in enumerate(spans):
        events.append((sp.start_us, 1, i))
        events.append((end_us if sp.end_us is None else sp.end_us, 0, i))
    events.sort()
    out, stack, t = [], [], None
    for when, opens, i in events:
        if stack and when > t:
            out.append((t, when, spans[stack[-1]].name))
        t = when
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    return out


def idle_by_span(gaps: List[Interval], spans: List[Span]
                 ) -> Dict[str, float]:
    """Idle seconds by the innermost program span open during each gap
    (`gaps` in start order, on the spans' clock; `outside` where no span
    is open), longest first."""
    pieces = innermost(spans, max((e for _, e in gaps), default=0.0))
    acc: Dict[str, float] = {}
    j = 0
    for s, e in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                acc[name] = acc.get(name, 0.0) + d / 1e6
                covered += d
            k += 1
        if e - s > covered:
            acc[OUTSIDE] = acc.get(OUTSIDE, 0.0) + (e - s - covered) / 1e6
    return dict(sorted(acc.items(), key=lambda kv: -kv[1]))


def per_nfe(idle: Dict[str, float], host_reads: Optional[int],
            nfes: int) -> Dict[str, float]:
    """The split's per-layer figures over `nfes` NFEs: each layer's idle
    ms an NFE, and the blocking host reads an NFE (None: not counted)."""
    if not nfes:
        return {}
    out = {m: 1e3 * sum(idle.get(n, 0.0) for n in names) / nfes
           for m, names in LAYERS.items()}
    if host_reads is not None:
        out["host_reads_per_nfe"] = host_reads / nfes
    return out
