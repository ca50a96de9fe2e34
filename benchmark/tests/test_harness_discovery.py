"""The harness finds a cell's configuration, traffic mix, limits and
per-layer readers by the names in BENCHMARK.json, and a cell added as new
files and entries in a copy of the benchmark is found without editing any
file that was there."""

import json
import os
import shutil

import tiny
from harness import spec

CELLS = ("ffhq_dwt_var.inpaint.b8", "imagenet_winograd.inpaint.b2")


def test_every_cell_of_the_benchmark_loads():
    per_layer = {}
    for name in CELLS:
        c = spec.load_cell(name, tiny.ROOT)
        assert c.chips == 1
        assert {m["name"] for m in c.end_to_end} == {
            "images_per_s", "peak_gib", "setup_s"}
        assert set(c.readers) == {m["name"] for m in c.per_layer}
        assert all(callable(r) for r in c.readers.values())
        assert set(c.limits) == {"unet_err", "step_err_closed",
                                 "step_err_cg"}
        per_layer[name] = set(c.readers)
    common = {"nfe_ms_p95", "cg_iters", "mfu", "device_idle_share"}
    assert per_layer[CELLS[0]] == common | {"haar_dwt_us_per_launch"}
    assert per_layer[CELLS[1]] == common | {"winograd_roofline"}


def test_a_cell_added_as_files_is_found(tmp_path):
    """A configuration, a mix, a cell and a metric added to a copy of the
    benchmark as new files and new entries: the harness reads them, and
    every file of the copy that was there is unchanged."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "ffhq256_adm_dwt_var.json").read_text())
    cfg["model"]["openai"]["num_channels"] = 192
    (b / "configs" / "new_model.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "inpaint.b8.json").read_text())
    tr["batch"] = 16
    (b / "traffic" / "new_mix.json").write_text(json.dumps(tr))
    (b / "limits" / "new_model.new_mix.json").write_text(json.dumps(
        {"unet_err": 0.5, "step_err_closed": 0.5, "step_err_cg": 0.5}))
    (b / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new_model", "source": "x",
                             "file": "benchmark/configs/new_model.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new_model.new_mix",
                               "config": "new_model", "traffic": "new_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "images_per_s",
                               "workloads": ["new_model.new_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.load_cell("new_model.new_mix", str(root))
    assert c.config["model"]["openai"]["num_channels"] == 192
    assert c.traffic["batch"] == 16
    assert c.limits["unet_err"] == 0.5
    assert c.readers["new_metric"](None) == 42.0
    assert "new_metric" not in spec.load_cell(CELLS[0], str(root)).readers
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_metric_without_workloads_goes_where_its_end_to_end_metric_is():
    e2e = [{"name": "a"}, {"name": "b", "workloads": ["x"]}]
    assert spec.applies({"moves": "a"}, "y", e2e)
    assert spec.applies({"moves": "b"}, "x", e2e)
    assert not spec.applies({"moves": "b"}, "y", e2e)
