"""Finds everything a run needs by the names in BENCHMARK.json: the cell
(`workloads`), its configuration (`configs[].file`), its traffic mix
(`traffic/<name>.json`), its limits (`limits/<cell>.json`) and the reader
of each per-layer metric (`metrics/<metric>.py`, a `read(run)` function).
A configuration, a mix, a cell or a metric is added by adding files and
entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int
    readers: Dict[str, Callable] = field(default_factory=dict)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_reader(path: str) -> Callable:
    """The `read` function of a metric's reader file."""
    name = "metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: Dict, cell: str, end_to_end: List[Dict]) -> bool:
    """Whether a metric is reported in `cell`: its `workloads`, else every
    cell (a per-layer metric: every cell that reports the metric it
    moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return any(m["name"] == moves and applies(m, cell, end_to_end)
               for m in end_to_end)


def load_cell(name: str, root: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json, with its files read from
    the benchmark's directory under `root` (the checkout)."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, os.path.basename(BENCH_DIR))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(here, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if applies(m, name, bench["end_to_end"])]
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, name, bench["end_to_end"])]
    readers = {m["name"]: load_reader(os.path.join(
        here, "metrics", m["name"] + ".py")) for m in per_layer}
    return Cell(name, config, traffic, limits, e2e, per_layer, w["chips"],
                readers)
