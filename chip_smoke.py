#!/usr/bin/env python3
"""Drives the PyTorch port (kdip_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout, holds each against its
plain PyTorch version on the card, runs the slice's main path through
`sampling_api.build_posterior_sampler` at the full width of the FFHQ-256
ADM UNet (random weights from a seed), and checks what comes out. Phases,
each printing one JSON line:

1. device and build: the card, versions, the nvcc build (parallel, one
   nvcc per source) with ptxas's register report;
2. kernels: the Haar DWT kernel against its plain version at
   [4, 3, 256, 256] float32, levels 1-3: forward, inverse, round trip, and
   the autograd backward;
3. slice, DWT-Var: ADMUNetV2 (bf16 torso, params pre-cast), p=0.5
   inpainting (configs/inpainting_config.yaml), Type-I guidance with the
   learned DWT covariance, mle threshold 1.0 (the CLI's --v2 default),
   50-step Heun with churn, 4 samples against one measurement; the DWT
   launch counts are reset just before and read just after;
4. one guided NFE below the threshold, with the kernel DWT and with the
   plain DWT, compared; the kernel run is traced with torch.profiler for
   the device's busy share and its top kernels;
5. slice, Convert: the V1 ADMUNet, Type-I guidance with the Convert
   covariance, the same sampler;
6. kernels_winograd: both entry points of the Winograd F(2,3) kernel
   against its plain version in bf16, with and without the fused
   prologue, at [1,128,256,256]->128, [1,1024,8,8]->512, a C and F that
   are not multiples of 16, and B=2, and through autograd (dx, da, db);
7. slice, Convert with the Winograd torso (`--winograd`): the V1 ADMUNet
   built by `config.make_openai_model` from configs/test_ffhq.json with
   winograd=True, the same guidance and sampler; the Winograd launch counts
   are reset just before and read just after, and must be 65 plain + 55
   fused per guided NFE;
8. one guided NFE below Convert's threshold three ways on the same
   weights: the kernels, their plain versions, and the direct cuDNN torso,
   compared; the kernel run is traced for the device's busy share, its
   time by kind and the Winograd kernels' device time;
9. the `kernels` line: per kernel, its launches in its slice (phases 3 and
   7), its error, its time against its plain version's, its bound and, for
   the Winograd kernels, cuDNN's direct conv, at the slice's hottest shape.

Then the card's name and power limit (nvidia-smi) and, last, the result
line. Any failed phase raises, so the script exits non-zero and prints no
result line; without a card, or without the package beside it, it exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth, the
# float32 rate outside the tensor cores, and the dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

SIZE = 256          # FFHQ-256
STEPS = 50          # SamplerConfig's default: Heun-50
# configs/inpainting_config.yaml
INPAINTING = dict(name="inpainting", sigma_s=0.05,
                  mask_opt=dict(mask_type="random", mask_prob_range=(0.5, 0.5),
                                image_size=256))
N_SAMPLES = 4
DWT_TOL = 1e-6      # kernel vs plain: the same float32 roundings (phase 2)
NFE_TOL = 1e-3      # kernel-DWT vs plain-DWT guided NFE (see phase 4)
NFE_REPS = 5        # timed calls per NFE variant in phases 4 and 8
# Winograd kernel vs its plain version (phase 6), per element:
# |d| <= 2^-7 |plain| + 2^-14 max|plain|, and at least 99% bit-equal. Both
# round the same values at the same places; only the float32 order of the
# 16 products' sums over C differs (tensor cores against a float32 matmul),
# so an output may round to its bf16 neighbour (one ulp, <= 2^-7 of it),
# and where cancellation leaves an output tiny the float32 noise of its
# terms decides (far below 2^-14 of the largest output).
WINO_REL, WINO_ABS, WINO_EQUAL = 2 ** -7, 2 ** -14, 0.99
# (B, C, F, H, W): the hottest FFHQ-256 shape, the deepest, C and F not
# multiples of 16 (H, W not multiples of 16 either), B = 2
WINO_SHAPES = ((1, 128, 128, 256, 256), (1, 1024, 512, 8, 8),
               (1, 40, 24, 18, 22), (2, 64, 32, 32, 32))
# phase 8 (see phase_nfe_winograd): one guided NFE below Convert's 0.2
# threshold; kernels vs plain versions, vs the direct torso
WINO_NFE_SIGMA = 0.1
WINO_DRIFT_RATIO = 3.0   # the kernels' drift from float32 / the others'
# phase 4's and 8's device time by kind, from the kernel's name (first match
# wins: "winograd" before "conv", which would swallow it)
KERNEL_KINDS = (("haar_dwt", ("haar_dwt2",)),
                ("winograd", ("winograd_f23",)),
                ("layout", ("nchwToNhwc", "nhwcToNchw")),
                ("conv_gemm", ("xmma", "cutlass", "gemm", "conv", "sm90_")),
                ("reduction", ("reduce_kernel", "reduce")),
                ("memcpy_memset", ("Memcpy", "Memset")),
                ("elementwise", ("elementwise", "copy_kernel", "Functor")))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def randomize_(model, seed: int, std: float = 0.02):
    """Draws every parameter from a seeded numpy generator, zero-initialised
    layers included (out.2, the ResBlock out_layers.3, proj_out), or eps is
    identically 0 and the run proves nothing: GroupNorm weights
    1 + std*N(0,1), everything else std*N(0,1)."""
    import torch
    from kdip_tpu_torch.models.layers import GroupNorm32
    norm_weights = {f"{n}.weight" for n, m in model.named_modules()
                    if isinstance(m, GroupNorm32)}
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            v = std * rng.standard_normal(p.shape, dtype=np.float32)
            if name in norm_weights:
                v += 1.0
            p.copy_(torch.from_numpy(v))
    return model


class PlainDWT:
    """OrthoTransform("dwt") on the plain PyTorch version: the comparison
    side of phase 4 (the port itself never sends a CUDA tensor there)."""

    def __init__(self, level: int = 3):
        self.level = level

    def __call__(self, x):
        from kdip_tpu_torch.ops.dwt import dwt2_plain
        return dwt2_plain(x, self.level)

    def inv(self, x):
        from kdip_tpu_torch.ops.dwt import idwt2_plain
        return idwt2_plain(x, self.level)


def cuda_time_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean time per call of fn() over `reps` back-to-back calls, by CUDA
    events: the device time, or the host's launch interval where that is
    longer."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device_and_build():
    import torch
    from kdip_tpu_torch.ops import _build
    t0 = time.perf_counter()
    log = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {src: [ln.strip() for ln in err.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, (_, err) in log.items()}
    emit({"phase": "device_and_build", "nvidia_smi": nvidia_smi(),
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_seconds": seconds, "built": sorted(log), "ptxas": ptxas})


def phase_kernels(dev):
    """Kernel vs plain version on the card, within DWT_TOL: both round each
    butterfly's sum, then its product with float32(1/sqrt2), so they should
    agree bit for bit."""
    import torch
    from kdip_tpu_torch.ops import dwt as D
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 3, 256, 256, generator=g, device=dev)
    ct = torch.randn(4, 3, 256, 256, generator=g, device=dev)
    errs = {}
    for level in (1, 2, 3):
        y = D.haar_dwt2_cuda(x, level, inverse=False)
        xi = D.haar_dwt2_cuda(x, level, inverse=True)
        back = D.haar_dwt2_cuda(y, level, inverse=True)
        xr = x.clone().requires_grad_(True)
        g_f, = torch.autograd.grad(D.dwt2(xr, level), xr, grad_outputs=ct)
        g_i, = torch.autograd.grad(D.idwt2(xr, level), xr, grad_outputs=ct)
        torch.cuda.synchronize()
        e = {"fwd": (y - D.dwt2_plain(x, level)).abs().max().item(),
             "inv": (xi - D.idwt2_plain(x, level)).abs().max().item(),
             "round_trip": (back - x).abs().max().item(),
             "bwd_fwd": (g_f - D.idwt2_plain(ct, level)).abs().max().item(),
             "bwd_inv": (g_i - D.dwt2_plain(ct, level)).abs().max().item()}
        errs[level] = e
        for k, v in e.items():
            tol = 2 * DWT_TOL if k == "round_trip" else DWT_TOL
            if not v <= tol:
                raise AssertionError(f"level {level} {k}: |d| {v} > {tol}")
    emit({"phase": "kernels", "shape": [4, 3, 256, 256], "tol": DWT_TOL,
          "round_trip_tol": 2 * DWT_TOL, "max_abs_err": errs})


def wino_inputs(dev, B, C, F, H, W, seed):
    """bf16 x [B, C, H, W] ~ N(0, 1), a weight [F, C, 3, 3] scaled to unit
    output variance, and the prologue's float32 a ~ 1 + 0.3 N, b ~ 0.3 N."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, C, H, W, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(F, C, 3, 3, generator=g, device=dev)
         / (9 * C) ** 0.5).to(torch.bfloat16)
    a = 1 + 0.3 * torch.randn(B, C, generator=g, device=dev)
    b = 0.3 * torch.randn(B, C, generator=g, device=dev)
    return x, w, a, b


def wino_compare(got, want, what, bit_equal=True):
    """The WINO_* tolerance; returns the record of one comparison."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > WINO_REL * want.abs()
               + WINO_ABS * want.abs().max()).sum())
    equal = (got == want).float().mean().item()
    if bad or (bit_equal and equal < WINO_EQUAL):
        raise AssertionError(f"{what}: {bad} elements out of tolerance, "
                             f"{equal:.5f} bit-equal")
    return {"max_abs_err": err.max().item(), "bit_equal": equal}


def phase_kernels_winograd(dev):
    """Both entry points against the plain version on the card, bf16, and
    the autograd of both ops (dx runs the kernel on the rotated weight; da,
    db follow from it) against the plain version's autograd."""
    import torch
    from kdip_tpu_torch.ops import winograd as Wg
    res = {}
    for i, shape in enumerate(WINO_SHAPES):
        x, w, a, b = wino_inputs(dev, *shape, seed=i)
        v = Wg.kernel_transform(w)
        key = "x".join(map(str, shape))
        for tag, pro in (("plain", None), ("fused", (a, b))):
            y = Wg.winograd_conv3x3_cuda(x, v, pro)
            torch.cuda.synchronize()
            res[f"{tag} {key}"] = wino_compare(
                y, Wg.winograd_conv3x3_plain(x, v, pro), f"{tag} {key}")
    x, w, a, b = wino_inputs(dev, *WINO_SHAPES[3], seed=9)
    g = torch.Generator(device=dev).manual_seed(10)
    B, _, F, H, W = WINO_SHAPES[3]
    ct = torch.randn(B, F, H, W, generator=g, device=dev).to(x.dtype)
    for tag in ("plain", "fused"):
        grads = []
        for conv in (None, Wg.winograd_conv3x3_plain):
            xs, as_, bs = (t.clone().requires_grad_(True) for t in (x, a, b))
            y = Wg.winograd_conv3x3(
                xs, w, prologue=(as_, bs) if tag == "fused" else None,
                conv=conv)
            wrt = [xs, as_, bs] if tag == "fused" else [xs]
            grads.append(torch.autograd.grad(y, wrt, grad_outputs=ct))
        torch.cuda.synchronize()
        for got, want, name in zip(*grads, ("dx", "da", "db")):
            # da, db are float32 sums of dx's terms: no bit-equal share
            res[f"autograd {tag} {name}"] = wino_compare(
                got, want, f"autograd {tag} {name}", bit_equal=name == "dx")
    emit({"phase": "kernels_winograd", "dtype": "bfloat16",
          "tol": {"rel": WINO_REL, "abs_of_max": WINO_ABS,
                  "min_bit_equal": WINO_EQUAL},
          "shapes_BCFHW": WINO_SHAPES, "results": res})


def build_slice(dev, v2: bool, seed: int, winograd: bool = False):
    """(model, tables, operator, measurement) of one configuration at full
    width: ffhq_unet (+ the out_cov head for v2), or with winograd the
    model the CLI builds (`config.make_openai_model` on
    configs/test_ffhq.json, winograd=True), weights from `seed`, bf16
    torso with the norm parameters in float32."""
    import torch
    from kdip_tpu_torch import config, diffusion, operators, weights
    from kdip_tpu_torch.models import adm
    if winograd:
        cfg = config.load_config(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "configs",
            "test_ffhq.json"))
        model, tables = config.make_openai_model(cfg["model"], winograd=True,
                                                 device=dev)
    else:
        model = adm.ffhq_unet(device=dev)
        tables = diffusion.make_diffusion(1000, "linear", device=dev)
    if v2:
        model = adm.ADMUNetV2(model)
    randomize_(model, seed)
    weights.precast_inference(model).eval().requires_grad_(False)
    op = operators.get_operator(
        seed=0, device=dev, **dict(INPAINTING, mask_opt=dict(
            INPAINTING["mask_opt"], image_size=SIZE)))
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    x_true = torch.rand(1, 3, SIZE, SIZE, generator=g, device=dev) * 2 - 1
    return model, tables, op, op.measure(x_true, generator=g), x_true


def winograd_per_nfe(model):
    """Winograd launches per guided NFE at B=1, from the model's blocks: the
    forward runs the plain kernel in each down-block's in_conv and the fused
    one in every other 3x3 conv of a ResBlock; the vjp runs the plain kernel
    once per conv (dx). FFHQ-256 (30 blocks, 5 down): 65 plain + 55 fused."""
    from kdip_tpu_torch.models.layers import ResBlock
    blocks = [m for m in model.modules() if isinstance(m, ResBlock)]
    down = sum(b.down for b in blocks)
    return {"winograd_conv3x3": down + 2 * len(blocks),
            "winograd_conv3x3_fused": 2 * len(blocks) - down}


def run_slice(name, dev, v2: bool, gcfg, seed: int, n: int,
              winograd: bool = False):
    """Heun-50 with churn, n samples against one measurement; returns the
    phase record (and the measurement pieces for phases 4 and 8)."""
    import torch
    from kdip_tpu_torch import sampling_api
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    model, tables, op, meas, x_true = build_slice(dev, v2, seed, winograd)
    scfg = sampling_api.SamplerConfig(steps=STEPS)
    sampler = sampling_api.build_posterior_sampler(
        model, tables, op, gcfg, scfg, v2=v2, image_size=SIZE, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 200)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    D.reset_launch_counts()
    Wg.reset_launch_counts()
    t0 = time.perf_counter()
    out, info = sampler(meas, n=n, generator=g, return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(D.launch_counts)
    wino_launches = dict(Wg.launch_counts)
    nfe = n * (2 * scfg.steps - 1)
    amax = out.abs().max().item()
    rec = {"phase": name, "n": n, "steps": scfg.steps,
           "wall_s": wall, "samples_per_s": n / wall, "nfe": nfe,
           "ms_per_nfe": 1e3 * wall / nfe,
           "cg_max_residual": info["cg_max_residual"],
           "cg_total_iters": info["cg_total_iters"],
           "dwt_launches": launches, "winograd_launches": wino_launches,
           "max_abs_out": amax,
           "finite": bool(torch.isfinite(out).all()),
           "mse_vs_truth": ((out - x_true) ** 2).mean().item(),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if out.shape != (n, 3, SIZE, SIZE) or not rec["finite"]:
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    # the last Euler step returns x + (x - den)/s * (-s): den in [-1, 1]
    # up to float32 rounding
    if amax > 1 + 1e-5:
        raise AssertionError(f"{name}: output outside [-1, 1]: {amax}")
    if winograd:
        # the per-sample loop calls the UNet once per sample and NFE
        per_nfe = winograd_per_nfe(model)
        rec["winograd_launches_per_nfe"] = {
            k: v / nfe for k, v in wino_launches.items()}
        want = {k: v * nfe for k, v in per_nfe.items()}
        if wino_launches != want:
            raise AssertionError(f"{name}: Winograd launches {wino_launches}"
                                 f", predicted {want}")
    elif sum(wino_launches.values()):
        raise AssertionError(f"{name} launched the Winograd kernel")
    return rec, (model, tables, op, meas, x_true)


def phase_nfe_compare(dev, gcfg, parts):
    """One guided NFE at sigma 0.5 (< mle threshold 1.0: a CG solve through
    the DWT covariance), kernel DWT vs plain DWT. Tolerance NFE_TOL: the
    two transforms should agree bit for bit (phase 2), but the UNet's
    convolutions and reductions need not repeat their summation order from
    call to call; a CG that stops at |r| <= 1e-4 |b| may then stop an
    iteration apart, and the difference of the solves reaches the output
    through the UNet vjp times sigma^2."""
    import torch
    from kdip_tpu_torch import guidance as gd
    from kdip_tpu_torch.ops import dwt as D
    model, tables, op, meas, x_true = parts
    sigma = 0.5
    uncond, var_fn = gd.make_openai_v2_uncond(model, tables, gcfg)
    den_k = gd.make_condition_denoiser(uncond, var_fn, op, meas, gcfg, v2=True,
                                       with_info=True)
    den_p = gd.make_condition_denoiser(uncond, var_fn, op, meas, gcfg, v2=True,
                                       with_info=True, ortho_tf=PlainDWT())
    g = torch.Generator(device=dev).manual_seed(7)
    x = x_true + sigma * torch.randn(x_true.shape, generator=g, device=dev)
    # the same NFE above the threshold: the closed-form solve, no CG
    sigma_hi = 2 * gcfg.mle_sigma_thres

    # the three variants in turns, NFE_REPS times after a warm-up, each
    # timed by its median wall: host time varies from call to call
    variants = {"kernel": (den_k, sigma), "plain": (den_p, sigma),
                "closed_form": (den_k, sigma_hi)}
    walls = {k: [] for k in variants}
    res = {}
    for rep in range(NFE_REPS + 1):
        for k, (den, s) in variants.items():
            D.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[k] = den(x, s)
            torch.cuda.synchronize()
            if rep:
                walls[k].append(1e3 * (time.perf_counter() - t0))
            if k == "plain" and sum(D.launch_counts.values()):
                raise AssertionError("the plain-DWT NFE launched the kernel")
    (out_k, info_k), (out_p, info_p) = res["kernel"], res["plain"]
    t_k, t_p, t_hi = (float(np.median(walls[k])) for k in variants)
    diff = (out_k - out_p).abs().max().item()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        den_k(x, sigma)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    kernels = device_events(prof)
    busy_ms = sum(k[0] for k in kernels)
    by_kind = {}
    for ms, _, name in kernels:
        kind = next((k for k, parts in KERNEL_KINDS if any(
            p in name for p in parts)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    rec = {"phase": "nfe_kernel_vs_plain_dwt", "sigma": sigma,
           "max_abs_diff": diff, "tol": NFE_TOL,
           "cg_iters": [info_k["cg_iters"], info_p["cg_iters"]],
           "cg_resid": [info_k["cg_resid"], info_p["cg_resid"]],
           "median_wall_ms": [t_k, t_p], "reps": NFE_REPS,
           "closed_form_sigma": sigma_hi, "closed_form_median_wall_ms": t_hi,
           "profiled_wall_ms": 1e3 * t_prof,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "device_ms_by_kind": by_kind,
           # busy time from the traced call, against the untraced calls'
           # median wall time (the tracer slows the host, not the device)
           "device_idle_share": (1 - busy_ms / t_k) if kernels
           else "not measured",
           "top_kernels_ms": [[round(k[0], 4), k[1], k[2][:80]]
                              for k in kernels[:10]]}
    emit(rec)
    if not diff <= NFE_TOL or abs(info_k["cg_iters"] - info_p["cg_iters"]) > 2:
        raise AssertionError(f"kernel vs plain NFE: {diff} > {NFE_TOL} or "
                             f"iterations {rec['cg_iters']}")


def device_events(prof):
    """[(ms, count, name)] of the device's own events in a torch.profiler
    trace (kernels, copies, sets), longest first. The operators' rows of
    key_averages() carry their kernels' device time too, so only rows of
    the device type are summed."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def profiled_kernel_ms(fn, name_part: str, reps: int = 50):
    """Mean device time of the kernels whose name holds `name_part` over
    `reps` calls of fn(), from torch.profiler (CUPTI); None where the trace
    shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ms for ms, _, name in device_events(prof) if name_part in name)
    return total / reps if total else None


def phase_nfe_winograd(dev, gcfg, parts):
    """One guided NFE at WINO_NFE_SIGMA (< Convert's threshold: a CG solve)
    on the Winograd slice's weights, three ways: the kernels, their plain
    versions (each conv's `conv_fn`; no launch may be counted), and the
    direct cuDNN torso (winograd off), timed in turns; and a float32 copy
    of the same (bf16-rounded) weights as the reference. Compared: the
    UNet's raw output at the NFE's input and its vjp at a fixed cotangent,
    the unconditional x0_mean and the variance that feeds the Convert
    covariance, and hat_x0.

    A bf16 torso of this depth carries any difference that flips one
    rounding from layer to layer until it reaches its own rounding noise:
    kernels and plain versions, which agree per conv on all but ~0.1% of
    the outputs by one ulp (phase 6), give UNets about as far apart as the
    Winograd and direct torsos are (on an H100 80GB HBM3: 4.4% and 7.1% of
    the largest output, max-relative). So the torso is held
    by its drift from float32 (norm-relative, output and vjp): the
    kernels' at most WINO_DRIFT_RATIO times the plain versions' and the
    direct torso's, the form of kdip_tpu's bf16 drift bound
    (tests/test_winograd.py:61-71 allows 6 times per conv); and the CG
    iterations of kernels and plain versions within 2. The max-relative
    differences between the variants are reported; hat_x0 = x0_mean +
    sigma^2 * vjp(mat) multiplies the vjp's noise where the Convert
    variance of random weights is small."""
    import copy

    import torch
    from kdip_tpu_torch import guidance as gd
    from kdip_tpu_torch import precond
    from kdip_tpu_torch.models.layers import Conv2d
    from kdip_tpu_torch.ops import winograd as Wg
    model, tables, op, meas, x_true = parts
    sigma = WINO_NFE_SIGMA
    uncond, var_fn = gd.make_openai_uncond(model, tables, gcfg)
    den = gd.make_condition_denoiser(uncond, var_fn, op, meas, gcfg,
                                     with_info=True)
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    per_nfe = winograd_per_nfe(model)

    def use(mode):
        model.set_winograd(mode != "direct")
        for m in convs:
            m.conv_fn = Wg.winograd_conv3x3_plain if mode == "plain" else None

    g = torch.Generator(device=dev).manual_seed(8)
    x = x_true + sigma * torch.randn(x_true.shape, generator=g, device=dev)
    ct = torch.randn((1, 6, SIZE, SIZE), generator=g, device=dev)
    x_in = x * float(np.float32(precond.eps_scalings(np.float32(sigma))[1]))
    t_b = precond.sigma_to_t(tables.log_sigmas, torch.tensor(
        sigma, device=dev)).floor().long().reshape(1)

    def torso(m):
        """The raw UNet output at the NFE's input, and its vjp at ct."""
        xg = x_in.detach().requires_grad_(True)
        y = m(xg, t_b)
        vjp, = torch.autograd.grad(y, xg, grad_outputs=ct)
        return {"unet_out": y.detach().float(), "unet_vjp": vjp.float()}

    variants = ("kernel", "plain", "direct")
    walls = {k: [] for k in variants}
    res, outs = {}, {}
    for rep in range(NFE_REPS + 1):
        for k in variants:
            use(k)
            Wg.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[k] = den(x, sigma)
            torch.cuda.synchronize()
            if rep:
                walls[k].append(1e3 * (time.perf_counter() - t0))
            want = per_nfe if k == "kernel" else dict.fromkeys(per_nfe, 0)
            if Wg.launch_counts != want:
                raise AssertionError(f"{k} NFE: Winograd launches "
                                     f"{Wg.launch_counts}, expected {want}")
    for k in variants:
        use(k)
        with torch.no_grad():
            x0m, aux = uncond(x, sigma)
        outs[k] = {"x0_mean": x0m.float(), "variance": aux["variance"].float(),
                   "hat_x0": res[k][0].float(), **torso(model)}
    use("kernel")
    ref = torso(copy.deepcopy(model).float())

    def max_rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def norm_rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    cmp = {other: {q: max_rel(outs["kernel"][q], outs[other][q])
                   for q in outs["kernel"]} for other in ("plain", "direct")}
    drift = {k: {q: norm_rel(outs[k][q], ref[q]) for q in ref}
             for k in variants}

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        den(x, sigma)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    kernels = device_events(prof)
    busy_ms = sum(k[0] for k in kernels)
    by_kind = {}
    for ms, _, name in kernels:
        kind = next((k for k, names in KERNEL_KINDS if any(
            p in name for p in names)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    t_k = float(np.median(walls["kernel"]))
    iters = {k: res[k][1]["cg_iters"] for k in variants}
    rec = {"phase": "nfe_winograd", "sigma": sigma, "t": int(t_b),
           "kernel_vs_max_rel": cmp, "norm_rel_vs_float32": drift,
           "drift_ratio_tol": WINO_DRIFT_RATIO,
           "cg_iters": iters,
           "cg_resid": {k: res[k][1]["cg_resid"] for k in variants},
           "median_wall_ms": {k: float(np.median(walls[k])) for k in variants},
           "reps": NFE_REPS, "winograd_launches_per_nfe": per_nfe,
           "profiled_wall_ms": 1e3 * t_prof,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "device_ms_by_kind": by_kind,
           "winograd_device_ms_per_nfe": by_kind.get("winograd", 0.0)
           if kernels else "not measured",
           "device_idle_share": (1 - busy_ms / t_k) if kernels
           else "not measured",
           "top_kernels_ms": [[round(k[0], 4), k[1], k[2][:80]]
                              for k in kernels[:10]]}
    emit(rec)
    fails = [f"drift {q}: kernels {drift['kernel'][q]}, {k} {drift[k][q]}"
             for q in ref for k in ("plain", "direct")
             if not drift["kernel"][q] <= WINO_DRIFT_RATIO * drift[k][q]]
    if abs(iters["kernel"] - iters["plain"]) > 2:
        fails.append(f"CG iterations {iters}")
    if fails:
        raise AssertionError(f"nfe_winograd: {fails}")


def wino_kernel_rows(dev, launches):
    """The kernels line's Winograd rows, at the hottest shape of the slice
    ([1,128,256,256] -> 128 bf16, B=1 under the per-sample loop). The bound:
    2*16*(H/2)*(W/2)*C*F tensor-core flops at the dense bf16 rate, against
    x + y + V (+ a, b) bytes at the HBM rate. The library yardstick is
    cuDNN's direct conv (F.conv2d, bf16), which computes the plain kernel's
    function; no single call computes the fused one (conv2d of
    silu(x*a + b)), so its row gives conv2d's time alone."""
    import torch
    import torch.nn.functional as F
    from kdip_tpu_torch.ops import winograd as Wg
    B, C, Fo, H, W = WINO_SHAPES[0]
    x, w, a, b = wino_inputs(dev, B, C, Fo, H, W, seed=3)
    v = Wg.kernel_transform(w)
    flops = 2 * 16 * (H // 2) * (W // 2) * C * Fo
    lib_ms = cuda_time_ms(lambda: F.conv2d(x, w, padding=1))
    rows = []
    for name, pro in (("winograd_conv3x3", None),
                      ("winograd_conv3x3_fused", (a, b))):
        nbytes = 2 * (x.numel() + B * Fo * H * W + v.numel()) + (
            2 * 4 * B * C if pro else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / BF16_TENSOR_FLOP_PER_S
        err = (Wg.winograd_conv3x3_cuda(x, v, pro).float()
               - Wg.winograd_conv3x3_plain(x, v, pro).float()).abs().max()

        def kern():
            return Wg.winograd_conv3x3_cuda(x, v, pro)
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(lambda: Wg.winograd_conv3x3_plain(x, v, pro),
                                reps=20, warmup=3)
        ms2 = cuda_time_ms(kern)
        rows.append({
            "name": name, "route": "cuda",
            "source": "kdip_tpu_torch/csrc/winograd_f23.cu",
            "replaces": "kdip_tpu/ops/experimental/winograd_pallas.py:60",
            "launches": launches[name], "max_abs_err": err.item(),
            "ms": min(ms, ms2), "ms_runs": [ms, ms2],
            "device_ms": profiled_kernel_ms(kern, "winograd_f23"),
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library_call": "torch.nn.functional.conv2d, bf16 (cuDNN)" + (
                "; no single call fuses silu(x*a+b): conv2d alone"
                if pro else ""),
            "shape_BCFHW": [B, C, Fo, H, W]})
    return rows


def kernel_rows(dev, launches):
    """The kernels line: each kernel at the slice's shape [1, 3, 256, 256]
    float32, level 3 (one sample under the per-sample loop)."""
    import torch
    from kdip_tpu_torch.ops import dwt as D
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, 3, 256, 256, generator=g, device=dev)
    n = x.numel()
    nbytes = 2 * 4 * n                      # read once, write once
    flops = 4 * n * (1 + 1 / 4 + 1 / 16)    # 16 add/sub/mul per 2x2, 3 levels
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S
                else "operations")
    rows = []
    for name, inverse, plain in (("haar_dwt2", False, D.dwt2_plain),
                                 ("haar_idwt2", True, D.idwt2_plain)):
        err = (D.haar_dwt2_cuda(x, 3, inverse) - plain(x, 3)).abs().max().item()
        ms = cuda_time_ms(lambda: D.haar_dwt2_cuda(x, 3, inverse))
        plain_ms = cuda_time_ms(lambda: plain(x, 3))
        ms2 = cuda_time_ms(lambda: D.haar_dwt2_cuda(x, 3, inverse))
        kname = "haar_dwt2_inv" if inverse else "haar_dwt2_fwd"
        rows.append({"name": name, "route": "cuda",
                     "source": "kdip_tpu_torch/csrc/haar_dwt.cu",
                     "replaces": "kdip_tpu/ops/pallas_dwt.py:49",
                     "launches": launches[name], "max_abs_err": err,
                     "ms": min(ms, ms2), "ms_runs": [ms, ms2],
                     "device_ms": profiled_kernel_ms(
                         lambda: D.haar_dwt2_cuda(x, 3, inverse), kname),
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": None})
        if not err <= DWT_TOL:
            raise AssertionError(f"{name} at the slice's shape: {err}")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    try:
        import kdip_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the kdip_tpu_torch package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    from kdip_tpu_torch import guidance as gd
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_device_and_build()
    phase_kernels(dev)

    dwt_cfg = gd.GuidanceConfig("I", ortho_tf_type="dwt", mle_sigma_thres=1.0)
    rec, parts = run_slice("slice_dwt_var", dev, True, dwt_cfg, seed=0,
                           n=N_SAMPLES)
    emit(rec)
    launches = rec["dwt_launches"]
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"the DWT-Var run launched no kernel: {launches}")

    phase_nfe_compare(dev, dwt_cfg, parts)
    del parts
    torch.cuda.empty_cache()

    convert_cfg = gd.GuidanceConfig("I", "convert")
    rec, _ = run_slice("slice_convert", dev, False, convert_cfg, seed=1,
                       n=N_SAMPLES)
    emit(rec)

    phase_kernels_winograd(dev)
    rec, parts = run_slice("slice_convert_winograd", dev, False, convert_cfg,
                           seed=2, n=N_SAMPLES, winograd=True)
    emit(rec)
    wino_launches = rec["winograd_launches"]
    if not all(v > 0 for v in wino_launches.values()):
        raise AssertionError(f"the Winograd run launched no kernel: "
                             f"{wino_launches}")
    phase_nfe_winograd(dev, convert_cfg, parts)
    del parts
    torch.cuda.empty_cache()

    emit({"kernels": kernel_rows(dev, launches)
          + wino_kernel_rows(dev, wino_launches)})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
