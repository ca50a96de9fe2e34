#!/usr/bin/env python3
"""The benchmark of kdip_tpu_torch, the PyTorch/CUDA port: one run of one
cell of BENCHMARK.json on the CUDA card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is a model configuration (`configs/`) under a traffic mix
(`traffic/`): batched guided posterior solves, B distinct images a solve,
one caller in a closed loop. The run makes its weights and inputs from the
seed on the card, warms up the cell's shapes, measures for --seconds (to
the next NFE boundary), then checks what the timed path produced against
the plain reference (`reference/`) and prints, as the last line of its
standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), device, with --trace 1 breakdown, and last "checks", each
number compared beside its limit (also the last lines of standard error).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result; if JAX or the JAX package was loaded, with 3.
The program's kernel builds and every cache stay inside the checkout.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "kdip_tpu")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(HERE, ".cache", _sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]


def process_start() -> float:
    """perf_counter()'s reading when this process started (from /proc,
    to the kernel's tick), else when this file began to run."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        now = time.perf_counter()
        return now - age if 0 <= age < now - T_IMPORT + 60 else T_IMPORT
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


CARD_FIELDS = ("index,name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
               "clocks.mem,temperature.gpu")


def card_lines():
    """The card's name, power limit and draw, clocks and temperature, as
    nvidia-smi reads them right after the window, with the reasons that
    hold its clocks down where this nvidia-smi knows them (nothing where
    nvidia-smi is missing)."""
    for fields in (CARD_FIELDS + ",clocks_event_reasons.active",
                   CARD_FIELDS):
        try:
            r = subprocess.run(
                ["nvidia-smi", f"--query-gpu={fields}",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return []
        if r.returncode == 0:
            return [f"{fields}: {line}"
                    for line in r.stdout.strip().splitlines()]
    return []


def result_line(cell, res, traced: bool, kind: str, count: int):
    """The contract's JSON object of a run (`res` from core.run_cell)."""
    from harness import check
    chk = res["check"]
    checks = {}
    ok = chk is not None and res["failed"] == 0 and res["fault"] is None \
        and res["steps_checked"] == res["steps_sampled"]
    for k in check.NUMBERS:
        v = None if chk is None else chk["numbers"][k]
        checks[k] = {"value": v, "limit": cell.limits[k]}
        ok = ok and v is not None and v <= cell.limits[k]
    run = res["run"]
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(res["metrics"][m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(res["peak_bytes"])}
    out = {"correct": bool(ok), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.seconds_by_kind(),
                            "idle_gaps": run.trace.idle_by_neighbours()}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import core, spec
    cell = spec.load_cell(args.workload, os.getcwd())
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available():
        print("run.py: no CUDA card; the benchmark measures the card and "
              "has no CPU path", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)          # the CUDA context
    t_cuda = time.perf_counter()
    early = {"python": T_IMPORT - t_start, "imports": t_torch - T_IMPORT,
             "cuda": t_cuda - t_torch}
    res = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        dev, t_start, early=early)
    for line in card_lines():
        print(f"card: {line}", flush=True)
    t_read = time.perf_counter()
    out = result_line(cell, res, bool(args.trace),
                      torch.cuda.get_device_name(dev), cell.chips)
    print(f"result s: {time.perf_counter() - t_read:.3f}", file=sys.stderr)
    found = banned_modules()
    if found:
        print(f"run.py: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps({k: res[k] for k in ("window_s", "nfes",
                                          "steps_checked")}
                     | {"check_calls": (res["check"] or {}).get("calls")}),
          flush=True)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
