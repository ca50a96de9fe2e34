#!/usr/bin/env python3
"""Benchmark of the PyTorch port (kdip_tpu_torch): guided posterior sampling
throughput on one CUDA card, the counterpart of bench.py.

    python3 bench_torch.py           # the row KDIP_BENCH_WORKLOAD names
    python3 bench_torch.py --grid    # every row, RESULTS_GRID_TORCH.json

The workload is bench.py's: the FFHQ-256 ADM UNet (random weights from a
seed, std 0.02, bf16 torso pre-cast), 1000-step linear DDPM tables, Type-I
guidance with the row's covariance on the row's operator (configs/),
50-step stochastic Heun, 4 samples against one measurement. One warm-up
call, then three timed calls ending in torch.cuda.synchronize(). `build`
makes the workload; chip_smoke.py builds its slices with it too.

Prints ONE JSON line with bench.py's keys. FLOPs per NFE come from
torch.utils.flop_counter over one guided NFE (UNet forward + vjp, B=1),
times 99 NFEs a sample; the peak from PEAK_BF16_TFLOPS, keyed by the
card's name, and a card not in it gets "mfu": null. vs_baseline divides by
BASELINE_MEASURED.json's measurement of the reference torch pipeline on a
CPU host (not this card's host), as bench.py does. Without a CUDA card it
exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

BATCH = 4
STEPS = 50
NFES = 2 * STEPS - 1     # Heun: two calls a step but the last

# bench.py's grid (bench.py:57-63): (operator yaml in configs/, posterior
# covariance type)
WORKLOADS = {
    "inpainting_convert": ("inpainting_config.yaml", "convert"),
    "gaussian_deblur_convert": ("gaussian_deblur_config.yaml", "convert"),
    "motion_deblur_convert": ("motion_deblur_config.yaml", "convert"),
    "sr4x_convert": ("super_resolution_4x_config.yaml", "convert"),
    "gaussian_deblur_tmpd": ("gaussian_deblur_config.yaml", "tmpd"),
}
DEFAULT_WORKLOAD = "inpainting_convert"
# --grid's limit on one row's subprocess: the tmpd row, whose CG runs its
# whole 1000-iteration budget at most NFEs, is the slowest
ROW_TIMEOUT_S = 2400

# dense bf16 tensor-core peaks in TFLOP/s (NVIDIA's data sheets, no
# sparsity), by torch.cuda.get_device_name(): H100 SXM at 700 W
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}

ROOT = os.path.dirname(os.path.abspath(__file__))
# the motion PSF of configs/motion_deblur_config.yaml (drawn with seed 0):
# the card's machine has no PIL to draw it
MOTION_PSF = os.path.join(ROOT, "kdip_tpu_torch", "data",
                          "motion_ks61_i0.5_seed0.npy")


def _metric_name(workload: str) -> str:
    op, cov = WORKLOADS[workload][0].replace("_config.yaml", ""), \
        WORKLOADS[workload][1]
    return (f"samples/sec/chip (FFHQ-256 guided 50-step Heun, "
            f"Type-I {cov}, {op})")


def load_measured_baseline():
    """(samples/s, source) of BASELINE_MEASURED.json, or (None, None)."""
    path = os.path.join(ROOT, "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        data = json.load(f)
    sps = data["extrapolated_50step"]["samples_per_sec"]
    hw = data["hardware"]
    return sps, (f"measured: reference torch pipeline on a "
                 f"{hw['cores']}-core {hw['cpu']} CPU host (torch "
                 f"{hw['torch']}), {sps:.6f} samples/s, not this card's "
                 f"host; see BASELINE_MEASURED.json / "
                 f"scripts/measure_reference.py")


def flops_per_nfe(model, dev) -> int:
    """FLOPs of one guided NFE's network work: the UNet forward at B=1 and
    its vjp with respect to x (the weights take no gradient)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    size = model.image_size
    x = torch.zeros(1, 3, size, size, device=dev, requires_grad=True)
    t = torch.full((1,), 500.0, device=dev)
    with FlopCounterMode(display=False) as counter:
        y = model(x, t)
        # backward, not autograd.grad: the counter's module hooks refuse
        # the latter
        y.backward(torch.ones_like(y))
    return counter.get_total_flops()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA card; the benchmark measures the card "
              "and has no CPU path", file=sys.stderr)
        return 2
    workload = os.environ.get("KDIP_BENCH_WORKLOAD", DEFAULT_WORKLOAD)
    if workload not in WORKLOADS:
        print(f"bench_torch: unknown workload {workload!r}; one of "
              f"{sorted(WORKLOADS)}", file=sys.stderr)
        return 2
    result = measure(workload, torch.device("cuda", 0),
                     torch.cuda.get_device_name(0))
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    return 0


def build(dev, gcfg, seed: int, op_cfg: dict, scfg=None, v2: bool = False,
          winograd: bool = False, model_config=None, measure=None,
          recon_mse=None):
    """One workload at full width, as this benchmark and chip_smoke.py's
    slices run it: (posterior sampler, (model, tables, operator,
    measurement, true image)). The model is the FFHQ-256 ADM UNet with
    1000-step linear DDPM tables (+ the out_cov head for v2), or the one
    the CLI builds from a configs/ file (`config.make_openai_model`: with
    winograd configs/test_ffhq.json, winograd=True; else `model_config`);
    weights from `seed` (std 0.02), the bf16 torso pre-cast with the norm
    parameters in float32; the operator from `op_cfg`; the measurement of
    a random image drawn from seed + 100 (`measure(op, x, generator)`,
    else op.measure); the sampler of `gcfg` and `scfg` (default:
    Heun-STEPS, one sample at a time)."""
    import torch
    from kdip_tpu_torch import (config, diffusion, operators, sampling_api,
                                weights)
    from kdip_tpu_torch.models import adm
    if winograd or model_config:
        cfg = config.load_config(os.path.join(
            ROOT, "configs", model_config or "test_ffhq.json"))
        model, tables = config.make_openai_model(cfg["model"],
                                                 winograd=winograd,
                                                 device=dev)
    else:
        model = adm.ffhq_unet(device=dev)
        tables = diffusion.make_diffusion(1000, "linear", device=dev)
    size = model.image_size
    if v2:
        model = adm.ADMUNetV2(model)
    weights.randomize_(model, seed)
    weights.precast_inference(model).eval().requires_grad_(False)
    op = operators.get_operator(seed=0, device=dev, **op_cfg)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    x_true = torch.rand(1, 3, size, size, generator=g, device=dev) * 2 - 1
    meas = (measure or (lambda o, x, gen: o.measure(x, generator=gen)))(
        op, x_true, g)
    sampler = sampling_api.build_posterior_sampler(
        model, tables, op, gcfg, scfg or sampling_api.SamplerConfig(
            steps=STEPS), recon_mse=recon_mse, v2=v2, image_size=size,
        device=dev)
    return sampler, (model, tables, op, meas, x_true)


def measure(workload: str, dev, name: str):
    """The workload's result dict on `dev`, the card called `name`; None
    if the warm-up sample is not finite."""
    import torch
    from kdip_tpu_torch import config, guidance
    op_yaml, cov = WORKLOADS[workload]
    op_cfg = config.load_yaml(os.path.join(ROOT, "configs", op_yaml))
    if op_cfg["name"] == "motion_blur":
        op_cfg.setdefault("kernel_path", MOTION_PSF)
    # cg_maxiter None: the reference's 1000-iteration budget; converging
    # solves exit early
    sampler, (model, _, _, meas, _) = build(
        dev, guidance.GuidanceConfig(guidance="I", x0_cov_type=cov), seed=0,
        op_cfg=op_cfg)

    def run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return sampler(meas, n=BATCH, generator=gen, return_info=True)
    out, info = run(3)                                   # warm-up
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        print("bench_torch: the warm-up sample is not finite",
              file=sys.stderr)
        return None
    cg_max_residual = info["cg_max_residual"]

    n_runs = 3
    t0 = time.perf_counter()
    for i in range(n_runs):
        out, info = run(4 + i)
        cg_max_residual = max(cg_max_residual, info["cg_max_residual"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_runs
    samples_per_sec = BATCH / dt

    flops = flops_per_nfe(model, dev)
    tflops = samples_per_sec * flops * NFES / 1e12
    peak = PEAK_BF16_TFLOPS.get(name)
    counted = (f"torch.utils.flop_counter.FlopCounterMode over one guided "
               f"NFE (UNet forward + vjp, B=1) = {flops / 1e9:.0f} GFLOP x "
               f"{NFES} NFEs/sample")
    mfu_method = (f"{counted}; peak {peak} dense bf16 TFLOP/s ({name})"
                  if peak else f"{counted}; no dense bf16 peak on record "
                  f"for {name!r}, so no mfu")

    if workload == DEFAULT_WORKLOAD:
        ref_sps, baseline_source = load_measured_baseline()
    else:
        ref_sps, baseline_source = None, (
            "baseline measured for the flagship inpainting workload only")
    return {
        "metric": _metric_name(workload),
        "value": round(samples_per_sec, 4),
        "unit": "samples/s",
        "vs_baseline": (round(samples_per_sec / ref_sps, 2)
                        if ref_sps else None),
        "baseline_source": baseline_source or "no measurement recorded",
        "tflops_sustained": round(tflops, 1),
        "mfu": round(tflops / peak, 4) if peak else None,
        # the worst CG relative residual of the four runs (tol 1e-4)
        "cg_max_residual": round(cg_max_residual, 8),
        "mfu_method": mfu_method,
        "device": name,
    }


def grid() -> int:
    """Every WORKLOADS row, each in a subprocess under ROW_TIMEOUT_S
    seconds; writes RESULTS_GRID_TORCH.json and prints one summary JSON
    line. A row that fails records its error."""
    import torch
    if not torch.cuda.is_available():
        print("bench_torch --grid: no CUDA card", file=sys.stderr)
        return 2
    rows = {}
    for workload in WORKLOADS:
        env = dict(os.environ, KDIP_BENCH_WORKLOAD=workload)
        t1 = time.time()
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                               env=env, timeout=ROW_TIMEOUT_S,
                               capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            rows[workload] = {"error": f"timeout after {ROW_TIMEOUT_S} s"}
            continue
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("{") and '"metric"' in ln]
        if r.returncode == 0 and lines:
            rows[workload] = dict(json.loads(lines[-1]),
                                  wall_s=round(time.time() - t1, 1))
        else:
            tail = (r.stderr or r.stdout).strip().splitlines()[-3:]
            rows[workload] = {"error": " | ".join(tail)[-500:]}
        print(f"[bench_torch --grid] {workload}: "
              f"{rows[workload].get('value', rows[workload].get('error'))}",
              file=sys.stderr)
    card = next((v["device"] for v in rows.values() if "device" in v),
                "card not reached")
    doc = {"config": f"FFHQ-256 guided {STEPS}-step stochastic Heun, Type-I "
                     f"guidance, batch {BATCH}, one {card}",
           "rows": rows}
    with open(os.path.join(ROOT, "RESULTS_GRID_TORCH.json"), "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({"grid": {k: (v.get("value"), v.get("cg_max_residual"))
                               for k, v in rows.items()},
                      "written": "RESULTS_GRID_TORCH.json"}))
    return 0 if all("error" not in v for v in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(grid() if "--grid" in sys.argv[1:] else main())
