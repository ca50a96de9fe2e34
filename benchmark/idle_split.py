#!/usr/bin/env python3
"""The card's idle time in a cell's traced slice, split by what the
program's host side was doing: one traced run of the cell, as
`run.py --trace 1` makes it, with the program's span recorder
(`kdip_tpu_torch.profiling.record_spans`) on from just before the window
opens until the trace is read after it closes.

    python3 benchmark/idle_split.py --workload <cell> --seed <n> \
        --seconds 50

Prints the run's result line (as run.py prints it), the span clock's
alignment on standard error (`span clock: <k> of <m> device reads inside
their read span, worst <x> us`, and the device clock's offset from the
host's, `harness.spans.DeviceClock`), and last one JSON object: the
slice's idle seconds by span (`idle_by_span`, `outside` where no span was
open),
the split's per-layer figures an NFE (`harness.spans.LAYERS` and
`host_reads_per_nfe`, the blocking reads of `guidance.host_read_counts`
over the slice), the recorder's cost on this host (ns a span on and off,
spans an NFE, their share of an untraced NFE) and the card. Not a
benchmark run: run.py does not turn the recorder on."""

import argparse
import json
import os
import statistics
import sys
import time

import run  # the benchmark's entry: its cache paths and sys.path first

from harness import core, spans, spec, trace  # noqa: I001

COST_SPANS = 200_000


def _host_reads():
    from kdip_tpu_torch import guidance
    return sum(getattr(guidance, "host_read_counts", {}).values())


class SpanTracer(trace.Tracer):
    """The harness's tracer with the span recorder: switched on at the
    first start (the warm-up tracer's, just before the window opens) and
    taken at the read after the window. Each start reads a clock pair and
    the host-read count, each stop the count again; the last tracer
    started is the slice's."""

    recording = False
    last = None

    def start(self):
        from kdip_tpu_torch import profiling
        if not SpanTracer.recording:
            profiling.record_spans(True)
            SpanTracer.recording = True
        super().start()
        self.pair = spans.clock_pair()
        self.reads0 = _host_reads()
        self.reads = self.records = self.calls = None
        SpanTracer.last = self

    def stop(self):
        super().stop()
        self.reads = _host_reads() - self.reads0
        self.pair_end = spans.clock_pair()

    def read(self):
        from kdip_tpu_torch import profiling
        self.records = profiling.take_spans()
        SpanTracer.recording = False
        t = super().read()
        self.calls = None if t is None else self.runtime_calls(t)
        return t

    def runtime_calls(self, t: trace.Trace):
        """For each device event of `t`, the host interval (us) of the
        runtime call that issued it (the earliest host record of its
        correlation id), or None."""
        from torch.autograd import DeviceType
        calls, corr = {}, {}
        for e in self.prof.profiler.kineto_results.events():
            cid = e.correlation_id()
            if not cid:
                continue
            s = e.start_ns() / 1e3
            if e.device_type() == DeviceType.CUDA:
                corr[(e.name(), s)] = cid
            elif cid not in calls or s < calls[cid][0]:
                calls[cid] = (s, s + e.duration_ns() / 1e3)
        return [calls.get(corr.get((n, s))) for n, s, _ in t.device]


def span_ns(n: int = COST_SPANS):
    """(ns a span with the recorder on, inside a parent span; ns with it
    off) on this host, over n spans each."""
    from kdip_tpu_torch import profiling
    span = profiling.span
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("off"):
            pass
    off = (time.perf_counter_ns() - t0) / n
    profiling.record_spans(True)
    with span("parent"):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("on"):
                pass
        on = (time.perf_counter_ns() - t0) / n
    profiling.take_spans()
    return on, off


def analyse(res, tracer: SpanTracer, log=print):
    """The split of a traced run (`res` from core.run_cell) whose slice
    `tracer` traced, as a dict; None where the run has no slice. The
    per-layer figures are the slice's, the span counts the window's."""
    r = res["run"]
    if r.trace is None or tracer is None or tracer.records is None:
        return None
    on = spans.on_trace_clock(tracer.records, tracer.pair)
    clock = spans.DeviceClock(r.trace, tracer.calls)
    al = spans.alignment(r.trace, clock, on)
    offsets = _quartiles(clock.offsets)
    log(f"span clock: {al['inside']} of {al['reads']} device reads inside "
        f"their read span, worst {al['worst_us']:.1f} us ({al['callers']} "
        f"outside every request: the caller's); device clock minus host "
        f"clock {offsets[0] if offsets else 0:.1f} to "
        f"{offsets[-1] if offsets else 0:.1f} us", file=sys.stderr)
    drift = ((tracer.pair_end[1] - tracer.pair[1])
             - (tracer.pair_end[0] - tracer.pair[0])) / 1e3
    idle = spans.idle_by_span(spans.host_gaps(r.trace, clock), on)
    by_name = {}
    for sp in on:
        by_name[sp.name] = by_name.get(sp.name, 0) + 1
    return {"idle_by_span": idle,
            "idle_s": sum(idle.values()),
            "window_s": r.trace.window_s, "busy_s": r.trace.busy_s(),
            "metrics": spans.per_nfe(idle, tracer.reads, r.traced_nfes),
            "span_clock": al | {"pair_drift_us": drift},
            "device_clock_offset_us": offsets,
            "spans_by_name": by_name,
            "spans_per_nfe": len(on) / res["nfes"]}


def _quartiles(v):
    """[min, q1, median, q3, max] of v (None for fewer than 2)."""
    if len(v) < 2:
        return None
    return [min(v)] + statistics.quantiles(v, n=4) + [max(v)]


def main(argv=None) -> int:
    t_start = run.process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("idle_split.py: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, os.getcwd())
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)
    trace.Tracer = SpanTracer
    res = core.run_cell(cell, args.seed, args.seconds, True, dev, t_start)
    name = torch.cuda.get_device_name(dev)
    out = run.result_line(cell, res, True, name, cell.chips)
    print(json.dumps(out), flush=True)
    split = analyse(res, SpanTracer.last)
    if split is None:
        print("idle_split.py: no traced slice", file=sys.stderr)
        return 1
    on_ns, off_ns = span_ns()
    rest = res["run"].nfe_seconds
    nfe_ns = 1e9 * sum(rest) / max(1, len(rest))
    split.update(
        workload=args.workload, seed=args.seed, correct=out["correct"],
        span_ns_on=on_ns, span_ns_off=off_ns,
        recorder_share_of_nfe=on_ns * split["spans_per_nfe"] / nfe_ns
        if rest else None,
        untraced_nfe_ms=nfe_ns / 1e6 if rest else None,
        card=run.card_lines())
    print(json.dumps(split), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
