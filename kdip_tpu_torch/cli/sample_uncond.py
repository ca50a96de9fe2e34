#!/usr/bin/env python
"""Unconditional sampling CLI (PyTorch port of `kdip_tpu/cli/sample_uncond.py`;
ref: GaussianDiffusion.p_sample_loop / ddim_sample_loop and the Karras
samplers through utils_model.model_fn).

    python -m kdip_tpu_torch.cli.sample_uncond --checkpoint model.pt \
        --config configs/test_ffhq.json --sampler dpmpp_2m --steps 25 \
        [--device cpu]

Generates -n unconditional samples from a guided-diffusion checkpoint with
a Karras sampler through the discrete eps denoiser (heun, euler, dpmpp_2m,
dpmpp_sde, lms, dpm_2), or with the discrete ancestral or DDIM chain over
the (optionally --respacing'd) tables, and writes `{prefix}_{i}.png` to
--logdir. The flags, defaults and artefacts are `kdip_tpu`'s, with one
more: `--device` (default `cuda`; the CPU only when asked for). The initial
x and the sampler's draws come from two torch.Generators seeded from
numpy's SeedSequence([seed, 0]) and ([seed, 1]).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import ckpt, config as kconfig, ddpm_sampling, diffusion, precond
from .. import samplers, schedules, weights
from ..data import to_uint8_image, write_png
from .sample_condition import _device, _generators

KARRAS = ("heun", "euler", "dpmpp_2m", "dpmpp_sde", "lms", "dpm_2")
DISCRETE = ("ancestral", "ddim")


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("-n", type=int, default=4, help="number of samples")
    p.add_argument("--sampler", default="heun", choices=KARRAS + DISCRETE)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--eta", type=float, default=0.0, help="ddim eta")
    p.add_argument("--respacing", default=None,
                   help="timestep respacing for the discrete chains, e.g. "
                        "'50' or 'ddim25' (ref: respace.py:7-60)")
    p.add_argument("--logdir", default="runs/sample_uncond")
    p.add_argument("--prefix", default="sample")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; pass cpu "
                        "to run on the CPU)")
    return p


def load_model(args, model_config, dev):
    """The UNet from the config and the checkpoint, pre-cast under --dtype
    bfloat16 (the GroupNorm parameters stay float32); and the tables."""
    sd = ckpt.load_torch_checkpoint(args.checkpoint)
    model, tables = kconfig.make_openai_model(model_config, device=dev)
    model = ckpt.load_strict(model, sd)
    if args.dtype == "bfloat16":
        weights.precast_inference(model)
    return model.eval().requires_grad_(False), tables


def draw_samples(args, model, tables, model_config, dev,
                 init_noise: Optional[torch.Tensor] = None,
                 noise_fn: Optional[Callable] = None,
                 noise_sampler: Optional[Callable] = None) -> torch.Tensor:
    """The -n samples [n, 3, H, W] of args.sampler. `init_noise` is the
    standard normal initial draw (x_T of the discrete chains; the Karras
    samplers start from it times sigma_max), `noise_fn(i)` step i's normal
    (the discrete chains, and heun's, euler's and dpm_2's churn), and
    `noise_sampler(sigma, sigma_next)` dpmpp_sde's; each is drawn from the
    run's generators when not given."""
    # SeedSequence([seed, 0]) and ([seed, 1]): jax's split(key)
    g_init, g_samp = _generators(args.seed, 0, dev)
    size = model_config["input_size"][0]
    shape = (args.n, 3, size, size)
    if init_noise is None:
        init_noise = torch.randn(shape, generator=g_init, device=dev)

    def model_fn(x, t):
        return model(x, t.to(torch.float32).expand(x.shape[0]))

    with torch.no_grad():
        if args.sampler in DISCRETE:
            if args.respacing:
                flags = dict(kconfig.OPENAI_MODEL_DEFAULTS)
                flags.update(model_config.get("openai", {}))
                tables = diffusion.make_diffusion(
                    flags["diffusion_steps"], flags["noise_schedule"],
                    args.respacing, device=dev)

            def model_fn_d(x, t):
                # respaced index -> original timestep (respace.py:116-128)
                return model_fn(x, diffusion.model_timesteps(tables, t))
            kw = dict(generator=g_samp, noise=init_noise, noise_fn=noise_fn,
                      device=dev)
            if args.sampler == "ancestral":
                return ddpm_sampling.p_sample_loop(tables, model_fn_d, shape,
                                                   **kw)
            return ddpm_sampling.ddim_sample_loop(tables, model_fn_d, shape,
                                                  eta=args.eta, **kw)

        denoise = precond.make_discrete_eps_denoiser(
            lambda x, t: model_fn(x, t)[:, :3], tables.log_sigmas)
        sigmas = schedules.get_sigmas_karras(
            args.steps, model_config["sigma_min"], model_config["sigma_max"])
        x = init_noise * float(np.float32(model_config["sigma_max"]))
        fn = getattr(samplers, f"sample_{args.sampler}")
        if args.sampler in ("heun", "euler", "dpm_2"):
            return fn(denoise, x, sigmas, noise_fn=noise_fn,
                      generator=g_samp)
        if args.sampler == "dpmpp_sde":
            return fn(denoise, x, sigmas, noise_sampler=noise_sampler,
                      generator=g_samp)
        return fn(denoise, x, sigmas)


def main(argv=None, **injected) -> torch.Tensor:
    """Runs the CLI; returns the samples [n, 3, H, W] on the run's device.
    `injected` passes draw_samples' init_noise / noise_fn /
    noise_sampler."""
    args = build_argparser().parse_args(argv)
    dev = _device(args.device)
    model_config = kconfig.load_config(args.config)["model"]
    model, tables = load_model(args, model_config, dev)
    out = draw_samples(args, model, tables, model_config, dev, **injected)
    os.makedirs(args.logdir, exist_ok=True)
    for i in range(args.n):
        write_png(os.path.join(args.logdir, f"{args.prefix}_{i}.png"),
                  to_uint8_image(out[i]))
    print(f"wrote {args.n} samples to {args.logdir}")
    return out


if __name__ == "__main__":
    main()
