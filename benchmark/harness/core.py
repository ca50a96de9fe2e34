"""One run of one cell: set-up, the measured window, the traced slice, the
check, the result.

Set-up makes the weights and every input from the seed on the device,
builds the program's model and its posterior sampler (the entry the CLI's
`--batch-size B -n 1` drives), and warms up the cell's shapes: one NFE
above the guidance threshold through the sampler itself, and a two-step
trajectory below it through a second sampler of the same model. The
window then runs whole batched solves back to back, one caller in a closed
loop, until the Clock closes it at an NFE boundary. A traced run
synchronises at every NFE boundary outside its profiled slice, a stretch
of the first solve's NFEs around the threshold (so both regimes are in
it; the mix's `trace_nfes` says how many on each side) that runs as the
untraced window does."""

from __future__ import annotations

import gc
import importlib
import os
import resource
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from harness import check, inputs, spec, trace, window, work
from reference import guided


def _module(kind: str, name: str):
    return importlib.import_module(f"{kind}.{name}")


def _counters() -> Dict[str, int]:
    """The program's launch counters (every `launch_counts` of its ops)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        counts = getattr(mod, "launch_counts", None)
        if name.startswith("kdip_tpu_torch.") and isinstance(counts, dict):
            for k, v in counts.items():
                out[k] = out.get(k, 0) + v
    return out


class Run:
    """What a run measured, as the per-layer readers see it."""

    def __init__(self, cell: spec.Cell, device_name: str):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.device_name = device_name
        self.peaks = work.peaks(device_name)
        self.batch = cell.traffic["batch"]
        self.image_size = cell.config["model"]["openai"]["image_size"]
        self.nfe_seconds = []        # untraced NFEs of a traced run
        self.cg_iters_first_solve: Optional[int] = None
        self.trace: Optional[trace.Trace] = None
        self.traced_nfes = 0
        self.counters: Dict[str, int] = {}
        self._model_meta = None

    def model_meta(self):
        """The reference model on the meta device (for work from shapes)."""
        if self._model_meta is None:
            fam = _module("families", self.config["family"])
            self._model_meta = fam.reference_model(self.config)
        return self._model_meta


def _trace_slice(sch: guided.Schedule, thres: float, above: int,
                 below: int):
    """The first solve's NFEs [a, b) around its first call below the
    threshold: up to `above` calls above it and `below` from it on."""
    sig = sch.call_sigmas()
    c = next((k for k, s in enumerate(sig) if s < thres), len(sig))
    return max(0, c - above), min(len(sig), c + below)


def _host_use():
    """(CPU seconds of this process, voluntary and involuntary context
    switches): what the host gave the run, for the window's log line."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime, r.ru_nvcsw, r.ru_nivcsw


def _log_trace(run: Run, a: int, b: int, log) -> None:
    """The slice on standard error: its NFEs, its device events, its pace
    against the synchronised NFEs outside it, and each kernel's launches
    in the trace beside the program's launch counters (a trace that lost
    records reads fewer)."""
    t, rest = run.trace, run.nfe_seconds
    counted = {p: sum(v for k, v in run.counters.items() if k.startswith(p))
               for p in ("winograd", "haar")}
    log(f"trace: NFEs [{a}, {b}), {len(t.device)} device events, "
        f"{1e3 * t.window_s / run.traced_nfes:.2f} ms an NFE traced, "
        f"{1e3 * sum(rest) / max(1, len(rest)):.2f} untraced; launches "
        f"traced / counted: winograd_f23 {t.kernel_launches('winograd_f23')}"
        f" / {counted['winograd']}, haar_dwt2 "
        f"{t.kernel_launches('haar_dwt2')} / {counted['haar']}",
        file=sys.stderr)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, controls=(), max_solves=None,
             log=print, early=None) -> Dict:
    """The run's result. `early` holds the set-up's phases before this
    call (name -> seconds, in order). `controls` names reference precisions
    (`reference.lowp`) to read in the program's place beside the check,
    and `max_solves` closes the window after that many solves: both for
    the control's readings, never in a benchmark run."""
    cfg, tr = cell.config, cell.traffic
    fam = _module("families", cfg["family"])
    opm = _module("operators", tr["operator"]["name"])
    dev = torch.device(device)
    B = tr["batch"]
    size = cfg["model"]["openai"]["image_size"]
    shape = (B, 3, size, size)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = Run(cell, name)

    early = dict(early or {})
    t_phase = time.perf_counter()
    phases = early | {"start" if early else "imports":
                      t_phase - t_start - sum(early.values())}

    def phase(name):
        nonlocal t_phase
        now = time.perf_counter()
        phases[name] = now - t_phase
        t_phase = now

    # weights, the program's model, the operator, the measurements
    ref_meta = run.model_meta()
    pshapes = [(n, p.shape) for n, p in ref_meta.named_parameters()]
    norms = fam.norm_names(ref_meta)
    std = cfg["weights"]["std"]
    state = inputs.weights(pshapes, norms, seed, std, dev)
    model, tables = fam.program_model(cfg, state, dev)
    del state
    phase("model")
    drawn = opm.draw(tr["operator"], seed, shape, dev)
    operator = opm.program(tr["operator"], drawn, dev)
    from kdip_tpu_torch.operators import Measurement
    pool = []
    for k in range(tr["solves_made"]):
        x = inputs.images(seed, k, shape, dev)
        n = inputs.noise(seed, "measure", k, 0, shape, dev)
        pool.append(opm.measure(tr["operator"], drawn, x, n))
    del x, n
    phase("inputs")

    s = tr["sampler"]
    sch = guided.Schedule(s["steps"], cfg["model"]["sigma_min"],
                          cfg["model"]["sigma_max"], s["rho"], s["s_churn"],
                          s["s_tmin"], s["s_tmax"], s["s_noise"])
    thres = cfg["guidance"]["mle_sigma_thres"]
    steps = check.sampled_steps(sch, thres, seed, tr["check"]["closed_steps"],
                                tr["check"]["cg_steps"])
    keep_in, keep_out = check.calls_of(steps)
    clock = window.Clock(dev, seconds, sync_each=traced)
    capture = window.Capture(0, keep_in, keep_out)
    counted = window.Counted(model, clock, capture)
    sample = fam.program_sampler(cfg, tr, counted, tables, operator, dev)

    def draws(k):
        init = inputs.noise(seed, "init", k, 0, shape, dev)
        return dict(init_noise=init, noise_fn=lambda i: inputs.noise(
            seed, "churn", k, i, shape, dev))

    def solve(smp, k, **kw):
        g = inputs.generator(dev, seed, "sampler", k)
        return smp(Measurement(pool[k % len(pool)]), n=B, generator=g,
                   return_info=True, **kw)

    # warm-up: one NFE above the threshold through the sampler, then a
    # two-step trajectory below it (three NFEs) through a second sampler of
    # the same model; draws of their own, none of the window's
    clock.stop_after = 1
    try:
        solve(sample, 1, **draws(-1))
    except window.WindowClosed:
        pass
    clock.stop_after, clock.calls = None, 0
    low = fam.program_sampler(cfg, tr, counted, tables, operator, dev,
                              sampler_overrides=dict(steps=2,
                                                     sigma_max=thres / 2))
    solve(low, 1, **draws(-2))
    phase("warm_up")
    if traced:
        warm = trace.Tracer()      # the profiler's first start is slow
        warm.start()
        warm.stop()
        tracer = trace.Tracer()
        a, b = _trace_slice(sch, thres, tr["trace_nfes"]["above"],
                            tr["trace_nfes"]["below"])
        marks = {}

        def begin():
            marks["counters"] = _counters()
            tracer.start()

        def end():
            tracer.stop()
            run.counters = {k: v - marks["counters"].get(k, 0)
                            for k, v in _counters().items()}
            run.traced_nfes = b - a
        clock.hooks = {a: begin, b: end}
        clock.free = set(range(a + 1, b))
    window.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    phase("tracer" if traced else "sync")
    t_window = time.perf_counter()
    setup_s = t_window - t_start

    # the window
    attempted = failed = 0
    infos, fault, solve_ends = [], None, []
    host0 = _host_use()
    clock.open()
    for k in range(sys.maxsize):
        capture.begin(k)
        attempted += B
        try:
            out, info = solve(sample, k, **draws(k))
        except window.WindowClosed:
            break
        except Exception:                  # the program failed: report it
            fault = traceback.format_exc()
            failed += B
            clock.close()
            break
        if not bool(torch.isfinite(out).all()):
            failed += B
        solve_ends.append(time.perf_counter())
        infos.append(info)
        if max_solves is not None and k + 1 >= max_solves:
            break
    if clock.t_end is None:
        clock.close()
    host = [b - a for a, b in zip(host0, _host_use())]
    window_s = clock.t_end - clock.t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    nfes = clock.nfes - (1 if fault else 0)
    if fault:
        log(fault, file=sys.stderr)
    log("set-up s by phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    ends = [clock.t0] + solve_ends
    log(f"window: {window_s:.3f} s, {clock.nfes} NFEs, solves s "
        + " ".join(f"{e - s:.3f}" for s, e in zip(ends, ends[1:]))
        + f"; host CPU s {host[0]:.3f}, context switches {host[1]} "
        f"voluntary, {host[2]} involuntary; load {os.getloadavg()[0]:.2f}",
        file=sys.stderr)
    solves = len(infos)
    if infos:
        run.cg_iters_first_solve = int(infos[0]["cg_total_iters"])
    if traced:
        if "counters" in marks and not run.traced_nfes:
            tracer.stop()          # the window closed inside the slice
        run.nfe_seconds = clock.nfe_seconds(set(range(a, b + 1)))
        t_read = time.perf_counter()
        run.trace = tracer.read() if run.traced_nfes else None
        log(f"trace read s: {time.perf_counter() - t_read:.3f}",
            file=sys.stderr)
        if run.trace is not None:
            _log_trace(run, a, b, log)

    metrics = {
        "images_per_s": B * nfes / tr["nfes_per_image"] / window_s,
        "peak_gib": peak / 2 ** 30,
        "setup_s": setup_s,
    }

    # the check, after the program's state is freed
    del sample, low, counted, model, tables, operator, infos
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done = [i for i in steps if 2 * i + 2 in capture.x]
    result = {"window_s": window_s, "nfes": nfes, "attempted": attempted,
              "failed": failed, "metrics": metrics, "peak_bytes": peak,
              "solves": solves, "steps_checked": done,
              "steps_sampled": steps, "run": run,
              "fault": fault}
    if not done:
        result["check"] = None
        return result
    t_check = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        state = inputs.weights(pshapes, norms, seed, std, dev)
        ref = fam.reference_model(cfg)
        ref.load_state_dict(state, assign=True)
        ref.requires_grad_(False)
        moments = fam.reference_moments(cfg, ref, dev)
        ctrl = {}
        for cname in controls:
            q = getattr(importlib.import_module("reference.lowp"), cname)
            cm = fam.reference_model(cfg, q)
            cm.load_state_dict(state, assign=True)
            cm.requires_grad_(False)
            ctrl[cname] = fam.reference_moments(cfg, cm, dev)
        start = inputs.noise(seed, "init", 0, 0, shape, dev) \
            * float(cfg["model"]["sigma_max"])
        if sch.bump(0):
            start = start + inputs.noise(seed, "churn", 0, 0, shape, dev) \
                * sch.s_noise * sch.bump(0)
        problem = opm.reference(tr["operator"], drawn, pool[0])
        result["check"] = check.compare(
            done, sch, capture.x, capture.out, start,
            lambda i: inputs.noise(seed, "churn", 0, i, shape, dev),
            problem, cfg["guidance"], moments, ctrl)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    log(f"check s: {time.perf_counter() - t_check:.3f}", file=sys.stderr)
    return result
