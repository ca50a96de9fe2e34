"""The program's spans against the device trace (`harness/spans.py`) and
the tool that splits a slice's idle time by them (`idle_split.py`), on
synthetic traces and spans, and on a CPU run of a tiny cell whose "device"
is stood in for by the spans themselves."""

import time

import pytest

import tiny  # noqa: I001  (puts the benchmark's folder on sys.path)
import idle_split
from harness import spans, trace
from kdip_tpu_torch import profiling
from kdip_tpu_torch.profiling import SpanRecord

DTOH = "Memcpy DtoH (Device -> Pageable)"


def _sp(name, s, e, parent=-1, request=-1):
    return spans.Span(name, float(s), None if e is None else float(e),
                      parent, request)


def _trace(events, start, end):
    return trace.Trace([(n, float(s), float(e)) for n, s, e in events],
                       float(start), float(end))


def _idle(t):
    return t.window_s - t.busy_s()


def _calls(t, skew=0.0, lag=None):
    """Each piece of work of t issued by a 1 us call as it starts on a
    device clock `skew` us ahead of the host's (`lag[i]` us before, where
    given)."""
    lag = lag or [0.0] * len(t.device)
    return [(s - skew - d, s - skew - d + 1)
            for (_, s, _), d in zip(t.device, lag)]


def _split(t, sp, skew=0.0):
    clock = spans.DeviceClock(t, _calls(t, skew))
    assert clock.offsets == [skew] * len(t.device)
    return spans.idle_by_span(spans.host_gaps(t, clock), sp)


@pytest.mark.parametrize("skew", [0.0, 5000.0, -250.0])
def test_a_gap_splits_across_nested_spans_by_self_time(skew):
    """Idle 10-90 us under a request (0-100) holding a step (20-80) holding
    an NFE (30-50): the NFE takes 20 us, the step 40 - 20, the request 20,
    whatever the device clock's offset from the host's."""
    t = _trace([("k", 0 + skew, 10 + skew), ("k", 90 + skew, 100 + skew)],
               skew, 100 + skew)
    sp = [_sp("sampling_api.sample", 0, 100, -1, 0),
          _sp("samplers.step", 20, 80, 0, 0),
          _sp("guidance.nfe", 30, 50, 1, 0)]
    idle = _split(t, sp, skew)
    assert idle == pytest.approx({"sampling_api.sample": 20e-6,
                                  "samplers.step": 40e-6,
                                  "guidance.nfe": 20e-6})
    assert sum(idle.values()) == pytest.approx(_idle(t))


def test_a_gap_outside_every_span_goes_to_outside():
    t = _trace([("k", 0, 10), ("k", 50, 60), ("k", 70, 100)], 0, 100)
    sp = [_sp("guidance.forward", 5, 55)]
    idle = _split(t, sp)
    # 10-50 under the forward; 60-70 outside
    assert idle == pytest.approx({"guidance.forward": 40e-6,
                                  spans.OUTSIDE: 10e-6})
    assert sum(idle.values()) == pytest.approx(_idle(t))


def test_a_gap_that_a_read_span_ends():
    """The host blocks in a read from 40 us; the copy runs at 70-72 us and
    ends the gap: 20-40 under the solve, 40-70 under the read."""
    t = _trace([("k", 0, 20), (DTOH, 70, 72), ("k", 72, 90)], 0, 90)
    sp = [_sp("guidance.solve", 10, 95),
          _sp(spans.HOST_READ, 40, 75, 0)]
    idle = _split(t, sp)
    assert idle == pytest.approx({spans.HOST_READ: 30e-6,
                                  "guidance.solve": 20e-6})
    assert sum(idle.values()) == pytest.approx(_idle(t))


def test_an_open_span_runs_to_the_slices_end_and_overlaps_are_one_busy():
    t = _trace([("k", 0, 30), ("k", 10, 20), ("k", 60, 100)], 0, 100)
    sp = [_sp("samplers.step", 40, None)]
    idle = _split(t, sp)
    assert idle == pytest.approx({spans.OUTSIDE: 10e-6,
                                  "samplers.step": 20e-6})
    assert sum(idle.values()) == pytest.approx(_idle(t))


def test_the_device_clock_is_the_least_lag_within_the_window():
    """Work queued behind other work starts long after its call; the
    offset near each piece is the least start - call within the window,
    each lag counted up by the most the clock can drift from it, so it
    follows a clock that drifts and jumps."""
    starts = [0, 10, 20, 30, 1000, 1010, 1020]
    t = _trace([("k", s, s + 5) for s in starts], 0, 1025)
    skew = [100, 100, 100, 100, 160, 160, 160]     # a jump of 60 us
    lag = [3, 400, 2, 900, 5, 700, 4]
    calls = [(s - k - d, s - k - d + 1)
             for s, k, d in zip(starts, skew, lag)]
    clock = spans.DeviceClock(t, calls, window_us=50, drift=0.1)
    assert clock.offsets == pytest.approx([103, 103, 102, 103, 165, 165,
                                           164])
    assert clock.offset(500) == pytest.approx(103)
    assert clock.offset(700) == pytest.approx(165)
    assert clock.host(1020, 1025) == pytest.approx((856, 861))
    assert spans.DeviceClock(t, [None] * 7).offset(5) == 0.0
    # a drifting clock, work paced only at the ends: the offset between
    # is the nearer end's, drifted
    t = _trace([("k", 0, 1), ("k", 500, 501), ("k", 1000, 1001)], 0, 1001)
    calls = [(0, 1), (500 - 900, 0), (1000 - 10, 0)]
    clock = spans.DeviceClock(t, calls, window_us=2000, drift=0.01)
    assert clock.offsets == pytest.approx([0, 5, 10])


def test_the_clock_pair_moves_spans_onto_the_trace_clock():
    recs = [SpanRecord("a", 1_000, 3_000, -1, -1),
            SpanRecord("b", 1_500, None, 0, -1)]
    pair = (500, 10_000_500)
    got = spans.on_trace_clock(recs, pair)
    assert got == [spans.Span("a", 10_001.0, 10_003.0, -1, -1),
                   spans.Span("b", 10_001.5, None, 0, -1)]
    p, w = spans.clock_pair()
    assert abs((time.time_ns() - w) - (time.perf_counter_ns() - p)) < 50e6


def test_alignment_counts_reads_inside_their_span_and_the_worst_miss():
    """The copies on the host clock (here 5 ms behind the device's)
    against the read spans."""
    skew = 5000.0
    t = _trace([(DTOH, 12 + skew, 13 + skew), (DTOH, 48 + skew, 52 + skew),
                ("k", 60 + skew, 61 + skew), (DTOH, 150 + skew, 151 + skew)],
               skew, 151 + skew)
    sp = [_sp(spans.REQUEST, 0, 100, -1, 0),
          _sp(spans.HOST_READ, 10, 20, 0, 0),
          _sp(spans.HOST_READ, 40, 50, 0, 0)]
    al = spans.alignment(t, spans.DeviceClock(t, _calls(t, skew)), sp)
    # the second copy ends 2 us past its read span; the last is the
    # caller's, after the request
    assert al == {"inside": 1, "reads": 2, "worst_us": 2.0, "callers": 1}


def test_per_nfe_figures_by_layer():
    idle = {"guidance.forward": 0.2, "guidance.vjp": 0.4,
            "guidance.solve": 0.01, spans.HOST_READ: 0.03,
            "sampling_api.sample": 0.001, "samplers.step": 0.002,
            "samplers.noise": 0.003, "guidance.nfe": 0.5, "outside": 0.1}
    got = spans.per_nfe(idle, 30, 10)
    assert got == pytest.approx({"fwd_idle_ms_per_nfe": 20.0,
                                 "vjp_idle_ms_per_nfe": 40.0,
                                 "cg_idle_ms_per_nfe": 4.0,
                                 "sampler_idle_ms_per_nfe": 0.6,
                                 "host_reads_per_nfe": 3.0})
    assert "host_reads_per_nfe" not in spans.per_nfe(idle, None, 10)
    assert spans.per_nfe(idle, 30, 0) == {}


def test_the_tools_split_of_a_cpu_run(monkeypatch):
    """A traced CPU run of the tiny DWT-Var cell through idle_split's
    tracer, whose "device", on a clock 5 ms ahead of the host's, is busy
    exactly under each vjp span and copies to the host in the middle of
    each read span, each issued by a call at its start: no idle under the
    vjp, every read inside its span, the split summing to the
    slice's idle time, one NFE span per NFE of the window and the slice's
    host reads the counter's."""
    skew = 5000.0
    marks = {}

    def start(self):
        marks["start"] = time.time_ns() / 1e3

    def stop(self):
        marks["stop"] = time.time_ns() / 1e3

    def read(self):
        on = spans.on_trace_clock(self.records, self.pair)
        a, b = marks["start"], marks["stop"]
        dev = [("elementwise_kernel", s.start_us, s.end_us) for s in on
               if s.name == "guidance.vjp" and a <= s.start_us < b]
        dev += [(DTOH, (s.start_us + s.end_us) / 2,
                 (s.start_us + s.end_us) / 2 + 0.001) for s in on
                if s.name == spans.HOST_READ and a <= s.start_us < b]
        dev = sorted(((n, s + skew, e + skew) for n, s, e in dev),
                     key=lambda d: d[1])
        return trace.Trace(dev, a + skew, max(e for _, _, e in dev))

    def runtime_calls(self, t):
        return [(s - skew, s - skew) for _, s, _ in t.device]
    monkeypatch.setattr(trace.Tracer, "start", start)
    monkeypatch.setattr(trace.Tracer, "stop", stop)
    monkeypatch.setattr(trace.Tracer, "read", read)
    monkeypatch.setattr(idle_split.SpanTracer, "runtime_calls",
                        runtime_calls)
    monkeypatch.setattr(trace, "Tracer", idle_split.SpanTracer)
    c = tiny.cell("dwt_var")
    res = tiny.core.run_cell(c, 2 ** 31 + 11, 1e9, True, "cpu",
                             time.perf_counter(), max_solves=1,
                             log=lambda *a, **k: None)
    lines = []
    got = idle_split.analyse(res, idle_split.SpanTracer.last,
                             log=lambda *a, **k: lines.append(a[0]))
    assert profiling.take_spans() == []
    nfes = res["run"].traced_nfes
    assert nfes == 4
    assert got["spans_by_name"]["guidance.nfe"] == res["nfes"]
    assert got["spans_per_nfe"] * res["nfes"] == sum(
        got["spans_by_name"].values())
    assert got["idle_by_span"].get("guidance.vjp", 0.0) == 0.0
    assert got["idle_s"] == pytest.approx(got["window_s"] - got["busy_s"],
                                          rel=1e-6)
    assert got["device_clock_offset_us"] == pytest.approx([skew] * 5)
    al = got["span_clock"]
    assert al["reads"] > 0 and al["inside"] == al["reads"]
    assert al["worst_us"] == 0.0
    assert lines[0].startswith(f"span clock: {al['reads']} of {al['reads']}")
    m = got["metrics"]
    tracer = idle_split.SpanTracer.last
    on = spans.on_trace_clock(tracer.records, tracer.pair)
    in_slice = [sp for sp in on if sp.name == spans.HOST_READ
                and marks["start"] <= sp.start_us < marks["stop"]]
    assert m["host_reads_per_nfe"] * nfes == len(in_slice) > 0
    assert m["vjp_idle_ms_per_nfe"] == 0.0
    assert m["fwd_idle_ms_per_nfe"] > 0
    on, off = idle_split.span_ns(1000)
    assert on > 0 and off > 0
