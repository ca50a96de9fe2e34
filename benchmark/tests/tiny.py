"""Cells of the benchmark at a size the CPU runs in seconds, for the
harness's tests: the configurations' and mixes' own files with the widths,
image size, batch and steps cut (an ADM UNet of 32 and 64 channels at
32 px, 2 images, Heun-6 or Heun-12), and a CPU run of them."""

import copy
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import core, spec  # noqa: E402

CELLS = {"dwt_var": ("ffhq256_adm_dwt_var.json", "inpaint.b8.json", 6,
                     "ffhq_dwt_var.inpaint.b8"),
         "winograd_convert": ("imagenet256_adm_winograd_convert.json",
                              "inpaint.b2.json", 12,
                              "imagenet_winograd.inpaint.b2")}


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def cell(kind: str) -> spec.Cell:
    """The tiny cell of `kind`, with the limits of the full-size cell it
    stands for."""
    cfg_file, tr_file, steps, full = CELLS[kind]
    cfg = copy.deepcopy(_json("configs", cfg_file))
    cfg["model"]["openai"].update(image_size=32, num_channels=32,
                                  num_res_blocks=1, channel_mult="1,2",
                                  attention_resolutions="16")
    tr = copy.deepcopy(_json("traffic", tr_file))
    tr.update(batch=2, nfes_per_image=2 * steps - 1, solves_made=2,
              trace_nfes={"above": 2, "below": 2})
    tr["sampler"]["steps"] = steps
    tr["operator"]["mask_opt"]["image_size"] = 32
    tr["check"] = {"closed_steps": 2, "cg_steps": 1}
    return spec.Cell(f"tiny_{kind}", cfg, tr, _json("limits", full + ".json"),
                     [], [], 1, {})


def run(c: spec.Cell, seed: int = 2 ** 31 + 7, seconds: float = 1e9,
        max_solves=1, controls=()):
    """A CPU run of a tiny cell (no card: the harness's look for one is
    run.py's, which this skips)."""
    return core.run_cell(c, seed, seconds, False, "cpu", time.perf_counter(),
                         controls=controls, max_solves=max_solves,
                         log=lambda *a, **k: None)
