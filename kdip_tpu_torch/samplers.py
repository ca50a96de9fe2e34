"""Karras samplers: Euler and Heun with churn, and DPM-Solver++(2M)
(PyTorch port of `kdip_tpu/samplers.py:37-178, 406-443`; ref:
k_diffusion/sampling.py:118-135, 159-184, 583-605).

A Python loop over the schedule. The per-step scalars (sigma, gamma, the
churn bump, DPM++'s log-sigma steps) are float32 on the host, computed as
`kdip_tpu` computes them on the device, so the `sigma_next == 0` and
mle-threshold branches cost no device read.

Every sampler takes `denoise(x, sigma) -> x0`, or with return_info a
denoiser that returns `(x0, info)` (guidance.make_condition_denoiser's
with_info), and then returns (x, info) with info["cg_max_residual"], the
worst CG relative residual of the trajectory, and info["cg_total_iters"].
Euler and Heun take `solver_state` for the CG warm start
(GuidanceConfig.cg_warm_start): each guided call starts from the state the
last one returned, the corrector from the predictor's (`kdip_tpu`
samplers.py:48-66).
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


class _Calls:
    """Calls the denoiser, tracking the worst CG residual, the summed CG
    iterations and, with a solver state, the warm-start carry."""

    def __init__(self, denoise: Callable, return_info: bool, solver_state):
        self.denoise, self.return_info = denoise, return_info
        self.state = solver_state
        self.worst, self.iters = 0.0, 0

    def __call__(self, x, sigma):
        if self.state is not None:
            out, info = self.denoise(x, sigma, solver_state=self.state)
            self.state = info["solver_state"]
        elif self.return_info:
            out, info = self.denoise(x, sigma)
        else:
            return self.denoise(x, sigma)
        self.worst = max(self.worst, info["cg_resid"])
        self.iters += info["cg_iters"]
        return out

    def finish(self, x):
        if self.return_info:
            return x, {"cg_max_residual": self.worst,
                       "cg_total_iters": self.iters}
        return x


def _churn(x, i, sig, gammas, s_noise, noise_fn, generator):
    """The step's churn: (x with the bump, sigma_hat). The noise is drawn
    every step, even where gamma is 0, as `kdip_tpu` draws it: from
    `noise_fn(step)` (standard normal, x's shape) when given, else from
    `generator`."""
    sigma, gamma = sig[i], gammas[i]
    eps = (noise_fn(i) if noise_fn is not None else torch.randn(
        x.shape, generator=generator, device=x.device, dtype=x.dtype))
    sigma_hat = sigma * (gamma + np.float32(1))
    if gamma > 0:
        bump = np.sqrt(max(sigma_hat ** 2 - sigma ** 2, np.float32(0)))
        x = x + eps * float(s_noise) * float(bump)
    return x, sigma_hat


def sample_euler(denoise: Callable, x: torch.Tensor, sigmas: torch.Tensor,
                 noise_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 s_churn: float = 0.0, s_tmin: float = 0.0,
                 s_tmax: float = float("inf"), s_noise: float = 1.0,
                 return_info: bool = False, solver_state=None):
    """Algorithm 2 of Karras et al. with Euler steps and churn (ref:
    k_diffusion/sampling.py:118-135; `kdip_tpu` samplers.py:71-112)."""
    sig = sigmas.detach().cpu().numpy().astype(np.float32)
    gammas = _churn_gammas(sig, s_churn, s_tmin, s_tmax)
    call = _Calls(denoise, return_info, solver_state)
    for i in range(len(sig) - 1):
        x, sigma_hat = _churn(x, i, sig, gammas, np.float32(s_noise),
                              noise_fn, generator)
        d = to_d(x, float(sigma_hat), call(x, float(sigma_hat)))
        x = x + d * float(sig[i + 1] - sigma_hat)
    return call.finish(x)


def sample_heun(denoise: Callable, x: torch.Tensor, sigmas: torch.Tensor,
                noise_fn: Optional[Callable] = None,
                generator: Optional[torch.Generator] = None,
                s_churn: float = 0.0, s_tmin: float = 0.0,
                s_tmax: float = float("inf"), s_noise: float = 1.0,
                return_info: bool = False, solver_state=None):
    """Algorithm 2 (Heun steps) of Karras et al. with churn; an Euler step
    when sigma_next is 0 (ref: k_diffusion/sampling.py:159-184; `kdip_tpu`
    samplers.py:115-178)."""
    sig = sigmas.detach().cpu().numpy().astype(np.float32)
    gammas = _churn_gammas(sig, s_churn, s_tmin, s_tmax)
    call = _Calls(denoise, return_info, solver_state)
    for i in range(len(sig) - 1):
        sigma_next = sig[i + 1]
        x, sigma_hat = _churn(x, i, sig, gammas, np.float32(s_noise),
                              noise_fn, generator)
        d = to_d(x, float(sigma_hat), call(x, float(sigma_hat)))
        dt = float(sigma_next - sigma_hat)
        if sigma_next == 0:
            x = x + d * dt
        else:
            x_2 = x + d * dt
            d_2 = to_d(x_2, float(sigma_next), call(x_2, float(sigma_next)))
            x = x + (d + d_2) / 2 * dt
    return call.finish(x)


def sample_dpmpp_2m(denoise: Callable, x: torch.Tensor, sigmas: torch.Tensor,
                    return_info: bool = False):
    """DPM-Solver++(2M) (ref: k_diffusion/sampling.py:583-605; `kdip_tpu`
    samplers.py:406-443): deterministic, one call a step; the first and
    the last step are first order. t = -log(sigma) and the step's
    coefficients are float32 host scalars."""
    sig = sigmas.detach().cpu().numpy().astype(np.float32)
    call = _Calls(denoise, return_info, None)
    one, half = np.float32(1), np.float32(0.5)
    with np.errstate(divide="ignore"):
        t = -np.log(sig)            # t of sigma 0 is inf: expm1(-h) = -1
    old = None
    for i in range(len(sig) - 1):
        denoised = call(x, float(sig[i]))
        h = t[i + 1] - t[i]
        ratio, decay = float(sig[i + 1] / sig[i]), float(-np.expm1(-h))
        if i == 0 or sig[i + 1] == 0:
            x = ratio * x + decay * denoised
        else:
            r = (t[i] - t[i - 1]) / h
            a, b = float(one + one / (2 * r)), float(one / (2 * r))
            x = ratio * x + decay * (a * denoised - b * old)
        old = denoised
    return call.finish(x)
