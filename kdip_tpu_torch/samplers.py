"""Karras Heun sampler (PyTorch port of `kdip_tpu/samplers.py:37-41,
115-178`; ref: k_diffusion/sampling.py:159-184).

A Python loop over the schedule. The per-step scalars (sigma, gamma, the
churn bump) are float32 on the host, computed as `kdip_tpu` computes them
on the device, so the `sigma_next == 0` and mle-threshold branches cost no
device read.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .schedules import to_d


def _churn_gammas(sigmas: np.ndarray, s_churn, s_tmin, s_tmax) -> np.ndarray:
    """Per-step churn gamma (ref: k_diffusion/sampling.py:164), float32."""
    n = sigmas.shape[0] - 1
    gamma_max = min(s_churn / n, 2 ** 0.5 - 1)
    on = (sigmas[:-1] >= s_tmin) & (sigmas[:-1] <= s_tmax)
    return np.where(on, np.float32(gamma_max), np.float32(0.0)).astype(np.float32)


def sample_heun(denoise: Callable, x: torch.Tensor, sigmas: torch.Tensor,
                noise_fn: Optional[Callable] = None,
                generator: Optional[torch.Generator] = None,
                s_churn: float = 0.0, s_tmin: float = 0.0,
                s_tmax: float = float("inf"), s_noise: float = 1.0,
                return_info: bool = False):
    """Algorithm 2 (Heun steps) of Karras et al. with churn; an Euler step
    when sigma_next is 0.

    `denoise(x, sigma) -> x0`, or `(x0, info)` with return_info (the
    guidance denoiser built with_info). The churn noise is drawn every step,
    even where gamma is 0, as `kdip_tpu` draws it: from `noise_fn(step)`
    (standard normal, x's shape) when given, else from `generator`.
    return_info returns (x, info) with info["cg_max_residual"], the worst CG
    relative residual of the trajectory, and info["cg_total_iters"]."""
    sig = sigmas.detach().cpu().numpy().astype(np.float32)
    gammas = _churn_gammas(sig, s_churn, s_tmin, s_tmax)
    s_noise = np.float32(s_noise)
    worst, iters = 0.0, 0

    def call(x, sigma):
        nonlocal worst, iters
        if not return_info:
            return denoise(x, sigma)
        out, info = denoise(x, sigma)
        worst = max(worst, info["cg_resid"])
        iters += info["cg_iters"]
        return out

    for i in range(len(sig) - 1):
        sigma, sigma_next, gamma = sig[i], sig[i + 1], gammas[i]
        eps = (noise_fn(i) if noise_fn is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype))
        sigma_hat = sigma * (gamma + np.float32(1))
        if gamma > 0:
            bump = np.sqrt(max(sigma_hat ** 2 - sigma ** 2, np.float32(0)))
            x = x + eps * float(s_noise) * float(bump)
        denoised = call(x, float(sigma_hat))
        d = to_d(x, float(sigma_hat), denoised)
        dt = float(sigma_next - sigma_hat)
        if sigma_next == 0:
            x = x + d * dt
        else:
            x_2 = x + d * dt
            d_2 = to_d(x_2, float(sigma_next), call(x_2, float(sigma_next)))
            x = x + (d + d_2) / 2 * dt
    if return_info:
        return x, {"cg_max_residual": worst, "cg_total_iters": iters}
    return x
