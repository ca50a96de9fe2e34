"""Posterior sampling API (PyTorch port of `kdip_tpu/sampling_api.py:25-148`):
build the guided denoiser for a measurement and run the Heun sampler over
the Karras schedule."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import diffusion as diff
from . import guidance as gd
from . import samplers, schedules
from .operators import Measurement


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler settings (defaults = the reference CLI's,
    sample_condition_openai.py:89-92, 186-194). per_sample_map runs each of
    n samples that share one measurement through its own denoiser call, and
    so its own CG solve, as `kdip_tpu` does by default."""
    steps: int = 50
    sigma_min: float = 1e-2
    sigma_max: float = 80.0
    rho: float = 7.0
    ode: bool = False       # True disables churn
    s_churn: float = 80.0
    s_tmin: float = 0.05
    s_tmax: float = 50.0
    s_noise: float = 1.003
    per_sample_map: bool = True


def build_posterior_sampler(model_apply: Callable,
                            tables: diff.DiffusionTables, operator,
                            guidance_cfg: gd.GuidanceConfig,
                            sampler_cfg: SamplerConfig = SamplerConfig(),
                            v2: bool = False, image_size: int = 256,
                            channels: int = 3, device="cuda"):
    """Returns `sample(measurement, n=1, ...) -> hat_x0` ([n, C, H, W]).

    model_apply(x_scaled, t) is the raw ADMUNet (v1) or the ADMUNetV2 (v2)
    forward; the model modules themselves qualify. The sampler runs on
    `device`; the model, tables, operator and measurement must live there.
    """
    sigmas = schedules.get_sigmas_karras(sampler_cfg.steps,
                                         sampler_cfg.sigma_min,
                                         sampler_cfg.sigma_max,
                                         sampler_cfg.rho)
    make_uncond = gd.make_openai_v2_uncond if v2 else gd.make_openai_uncond
    uncond, var_fn = make_uncond(model_apply, tables, guidance_cfg)
    churn = {} if sampler_cfg.ode else dict(
        s_churn=sampler_cfg.s_churn, s_tmin=sampler_cfg.s_tmin,
        s_tmax=sampler_cfg.s_tmax, s_noise=sampler_cfg.s_noise)

    def sample(measurement: Measurement, n: int = 1,
               generator: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None,
               noise_fn: Optional[Callable] = None,
               return_info: bool = False):
        """init_noise (standard normal [n, C, H, W]; scaled by sigma_max
        here) and noise_fn (churn noise per step, see
        samplers.sample_heun) inject the randomness; otherwise it comes
        from `generator`. return_info also returns the info dict of
        samplers.sample_heun."""
        denoise = gd.make_condition_denoiser(
            uncond, var_fn, operator, measurement, guidance_cfg, v2=v2,
            with_info=return_info)
        if sampler_cfg.per_sample_map and n > 1 and measurement.y.shape[0] == 1:
            denoise = _per_sample(denoise, return_info)
        if init_noise is None:
            init_noise = torch.randn((n, channels, image_size, image_size),
                                     generator=generator, device=device)
        x = init_noise.to(device) * sampler_cfg.sigma_max
        return samplers.sample_heun(denoise, x, sigmas, noise_fn=noise_fn,
                                    generator=generator,
                                    return_info=return_info, **churn)

    return sample


def _per_sample(denoise: Callable, with_info: bool) -> Callable:
    """Runs `denoise` on one sample at a time (`kdip_tpu`'s lax.map,
    sampling_api.py:110-132); the info reports the worst residual and the
    summed CG iterations."""
    def mapped(x, sigma):
        outs = [denoise(x[i:i + 1], sigma) for i in range(x.shape[0])]
        if not with_info:
            return torch.cat(outs)
        return torch.cat([o for o, _ in outs]), {
            "cg_resid": max(info["cg_resid"] for _, info in outs),
            "cg_iters": sum(info["cg_iters"] for _, info in outs)}
    return mapped
