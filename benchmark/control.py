#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card, at a
cell's own size: for each seed one run of the cell whose window holds its
first solve (the check's steps), with the program's numbers (the lower
readings) and those of the control, the reference computed in float8 e4m3
(`reference/lowp.py`) put in the program's place (the upper readings).

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 ...

Prints one JSON line a seed and a summary line; not a benchmark run."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=["fp8"])
    args = p.parse_args(argv)
    import torch
    from harness import check, core, spec
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, os.getcwd())
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = core.run_cell(cell, seed, 1e9, False, torch.device("cuda", 0),
                            t0, controls=args.controls, max_solves=1)
        c = res["check"]
        row = {"seed": seed, "program": c["numbers"],
               "controls": c["controls"], "calls": c["calls"],
               "cg_iters": res["run"].cg_iters_first_solve,
               "solve_s": res["window_s"], "failed": res["failed"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": args.seeds}
    for who in ["program"] + args.controls:
        for k in check.NUMBERS:
            vals = [r["program"][k] if who == "program"
                    else r["controls"][who][k] for r in rows]
            summary[f"{who}.{k}"] = {"min": min(vals), "max": max(vals)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
