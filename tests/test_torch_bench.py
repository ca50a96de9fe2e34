"""bench_torch.py, the port's benchmark, on the CPU: the same workloads and
metric names as bench.py, and no result without a CUDA card. Its run on
the card is chip_smoke.py's `bench_torch` phase."""

import json
import os
import subprocess
import sys

import pytest

import bench
import bench_torch
from test_torch_port import REPO


def test_workloads_and_metric_names_match_bench():
    assert bench_torch.WORKLOADS == bench.WORKLOADS
    assert bench_torch.DEFAULT_WORKLOAD == bench.DEFAULT_WORKLOAD
    assert (bench_torch.BATCH, bench_torch.STEPS) == (bench.BATCH,
                                                      bench.STEPS)
    for w in bench.WORKLOADS:
        assert bench_torch._metric_name(w) == bench._metric_name(w)
    assert bench_torch._metric_name(bench.DEFAULT_WORKLOAD) == bench.METRIC


@pytest.mark.parametrize("argv", [[], ["--grid"], ["--runs", "1"]],
                         ids=["row", "grid", "runs"])
def test_no_cuda_exits_nonzero_without_a_result(argv):
    """With no card visible the benchmark exits non-zero, says why on
    stderr and prints no JSON line: it never measures the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "bench_torch.py", *argv], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert not os.path.exists(os.path.join(REPO, "RESULTS_GRID_TORCH.json"))


def test_baseline_source_names_its_host():
    """vs_baseline's source is BASELINE_MEASURED.json's CPU measurement,
    labelled as such."""
    sps, src = bench_torch.load_measured_baseline()
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as f:
        want = json.load(f)["extrapolated_50step"]["samples_per_sec"]
    assert sps == want and "CPU host" in src and "not this card" in src
