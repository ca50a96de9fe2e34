"""Karras samplers (PyTorch port of `kdip_tpu/samplers.py`; ref:
k_diffusion/sampling.py:118-649): Euler and Heun with churn, Euler and
DPM-2 ancestral, DPM-2, LMS, DPM-Solver++ (2S ancestral, SDE, 2M, 2M SDE),
DPM-Solver fast and adaptive, and the probability-flow log-likelihood.

A Python loop over the schedule. The per-step scalars (sigma, gamma, the
churn bump, the ancestral split, the log-sigma steps) are float32 on the
host, computed as `kdip_tpu` computes them on the device, so the
`sigma_next == 0`, `sigma_down == 0` and mle-threshold branches cost no
device read.

Every sampler takes `denoise(x, sigma) -> x0`; Euler, Heun and DPM++(2M)
also take, with return_info, a denoiser that returns `(x0, info)`
(guidance.make_condition_denoiser's with_info), and then return (x, info)
with info["cg_max_residual"], the worst CG relative residual of the
trajectory, and info["cg_total_iters"]. Euler and Heun take `solver_state`
for the CG warm start (GuidanceConfig.cg_warm_start): each guided call
starts from the state the last one returned, the corrector from the
predictor's (`kdip_tpu` samplers.py:48-66).

Euler, Heun and DPM++(2M) mark each step as a
`profiling.span("samplers.step")`, and the churn's draw as
`samplers.noise`.

Noise is injectable: churn and per-step draws through `noise_fn(step)`,
the ancestral and SDE samplers' through `noise_sampler(sigma,
sigma_next)`; otherwise it is drawn from `generator` (the SDE samplers
seed their Brownian tree from it). Draws whose product is masked to 0 at
the last step are skipped.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .autoi import rademacher
from .brownian import BrownianTreeNoiseSampler
from .profiling import span
from .schedules import get_ancestral_step, to_d

F32 = np.float32


def _host_sigmas(sigmas) -> np.ndarray:
    """The schedule as float32 numpy on the host."""
    if torch.is_tensor(sigmas):
        sigmas = sigmas.detach().cpu().numpy()
    return np.asarray(sigmas, np.float32)


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
    with span("samplers.noise"):
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
    sig = _host_sigmas(sigmas)
    gammas = _churn_gammas(sig, s_churn, s_tmin, s_tmax)
    call = _Calls(denoise, return_info, solver_state)
    for i in range(len(sig) - 1):
        with span("samplers.step"):
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
    sig = _host_sigmas(sigmas)
    gammas = _churn_gammas(sig, s_churn, s_tmin, s_tmax)
    call = _Calls(denoise, return_info, solver_state)
    for i in range(len(sig) - 1):
        with span("samplers.step"):
            sigma_next = sig[i + 1]
            x, sigma_hat = _churn(x, i, sig, gammas, np.float32(s_noise),
                                  noise_fn, generator)
            d = to_d(x, float(sigma_hat), call(x, float(sigma_hat)))
            dt = float(sigma_next - sigma_hat)
            if sigma_next == 0:
                x = x + d * dt
            else:
                x_2 = x + d * dt
                d_2 = to_d(x_2, float(sigma_next),
                           call(x_2, float(sigma_next)))
                x = x + (d + d_2) / 2 * dt
    return call.finish(x)


def sample_dpmpp_2m(denoise: Callable, x: torch.Tensor, sigmas: torch.Tensor,
                    return_info: bool = False):
    """DPM-Solver++(2M) (ref: k_diffusion/sampling.py:583-605; `kdip_tpu`
    samplers.py:406-443): deterministic, one call a step; the first and
    the last step are first order. t = -log(sigma) and the step's
    coefficients are float32 host scalars."""
    sig = _host_sigmas(sigmas)
    call = _Calls(denoise, return_info, None)
    one, half = np.float32(1), np.float32(0.5)
    with np.errstate(divide="ignore"):
        t = -np.log(sig)            # t of sigma 0 is inf: expm1(-h) = -1
    old = None
    for i in range(len(sig) - 1):
        with span("samplers.step"):
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


# ---------------------------------------------------------------------------
# Ancestral and the other Karras-ODE samplers (ref: k_diffusion/
# sampling.py:139-275, 507-649; `kdip_tpu` samplers.py:181-503)
# ---------------------------------------------------------------------------

def _randn(x: torch.Tensor, generator) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def _noise_sampler(x, noise_sampler, generator) -> Callable:
    """The given noise sampler, else iid normals from `generator` (ref:
    k_diffusion/sampling.py:61-62)."""
    if noise_sampler is not None:
        return noise_sampler
    return lambda sigma, sigma_next: _randn(x, generator)


def _tree_sampler(x, sig: np.ndarray, noise_sampler, generator) -> Callable:
    """The given noise sampler, else a Brownian tree over the schedule's
    nonzero range (`kdip_tpu` samplers.py:358-364), its seed drawn from
    `generator`."""
    if noise_sampler is not None:
        return noise_sampler
    seed = torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                         device="cpu" if generator is None
                         else generator.device).item()
    return BrownianTreeNoiseSampler(
        x.shape, float(sig[sig > 0].min()), float(sig.max()), seed,
        device=x.device, dtype=x.dtype)


def sample_euler_ancestral(denoise: Callable, x: torch.Tensor, sigmas,
                           eta: float = 1.0, s_noise: float = 1.0,
                           noise_sampler: Optional[Callable] = None,
                           generator: Optional[torch.Generator] = None):
    """Ancestral sampling with Euler steps (ref: k_diffusion/sampling.py:
    139-155; `kdip_tpu` samplers.py:181-199)."""
    sig = _host_sigmas(sigmas)
    ns = _noise_sampler(x, noise_sampler, generator)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise(x, float(sigma))
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta)
        x = x + to_d(x, float(sigma), denoised) * float(sigma_down - sigma)
        if sigma_next > 0:
            x = x + ns(sigma, sigma_next) * float(F32(s_noise)) * float(
                sigma_up)
    return x


def sample_dpm_2(denoise: Callable, x: torch.Tensor, sigmas,
                 noise_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 s_churn: float = 0.0, s_tmin: float = 0.0,
                 s_tmax: float = float("inf"), s_noise: float = 1.0):
    """DPM-Solver-2 / Algorithm 2 hybrid with churn, an Euler step when
    sigma_next is 0 (ref: k_diffusion/sampling.py:187-214; `kdip_tpu`
    samplers.py:202-233)."""
    sig = _host_sigmas(sigmas)
    gammas = _churn_gammas(sig, s_churn, s_tmin, s_tmax)
    for i in range(len(sig) - 1):
        sigma_next = sig[i + 1]
        x, sigma_hat = _churn(x, i, sig, gammas, F32(s_noise), noise_fn,
                              generator)
        d = to_d(x, float(sigma_hat), denoise(x, float(sigma_hat)))
        if sigma_next == 0:
            x = x + d * float(sigma_next - sigma_hat)
        else:
            sigma_mid = np.exp((np.log(sigma_hat) + np.log(sigma_next))
                               / F32(2))
            x_2 = x + d * float(sigma_mid - sigma_hat)
            d_2 = to_d(x_2, float(sigma_mid), denoise(x_2, float(sigma_mid)))
            x = x + d_2 * float(sigma_next - sigma_hat)
    return x


def sample_dpm_2_ancestral(denoise: Callable, x: torch.Tensor, sigmas,
                           eta: float = 1.0, s_noise: float = 1.0,
                           noise_sampler: Optional[Callable] = None,
                           generator: Optional[torch.Generator] = None):
    """Ancestral DPM-Solver-2 (ref: k_diffusion/sampling.py:218-243;
    `kdip_tpu` samplers.py:236-264)."""
    sig = _host_sigmas(sigmas)
    ns = _noise_sampler(x, noise_sampler, generator)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise(x, float(sigma))
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta)
        d = to_d(x, float(sigma), denoised)
        if sigma_down == 0:
            x = x + d * float(sigma_down - sigma)
            continue
        sigma_mid = np.exp((np.log(sigma) + np.log(sigma_down)) / F32(2))
        x_2 = x + d * float(sigma_mid - sigma)
        d_2 = to_d(x_2, float(sigma_mid), denoise(x_2, float(sigma_mid)))
        x = x + d_2 * float(sigma_down - sigma)
        x = x + ns(sigma, sigma_next) * float(F32(s_noise)) * float(sigma_up)
    return x


def linear_multistep_coeff(order: int, t, i: int, j: int) -> float:
    """Integrated Lagrange-basis LMS coefficient (ref: k_diffusion/
    sampling.py:246-256), in float64 on the host. The integrand is a
    polynomial of degree order - 1, so Gauss-Legendre with ceil(order / 2)
    nodes integrates it exactly (the reference uses scipy's quad)."""
    if order - 1 > i:
        raise ValueError(f"LMS order {order} exceeds the {i} steps available")
    nodes, weights = np.polynomial.legendre.leggauss(max(1, -(-order // 2)))
    lo, hi = float(t[i]), float(t[i + 1])
    tau = (hi - lo) / 2 * nodes + (hi + lo) / 2
    prod = np.ones_like(tau)
    for k in range(order):
        if k != j:
            prod *= (tau - float(t[i - k])) / (float(t[i - j])
                                               - float(t[i - k]))
    return float((hi - lo) / 2 * np.dot(weights, prod))


def sample_lms(denoise: Callable, x: torch.Tensor, sigmas, order: int = 4):
    """Linear multistep sampler (ref: k_diffusion/sampling.py:259-275;
    `kdip_tpu` samplers.py:285-316): each step's coefficients, float32,
    against the newest derivatives first."""
    sig = _host_sigmas(sigmas)
    ds = []
    for i in range(len(sig) - 1):
        cur_order = min(i + 1, order)
        coeffs = [F32(linear_multistep_coeff(cur_order, sig, i, j))
                  for j in range(cur_order)]
        d = to_d(x, float(sig[i]), denoise(x, float(sig[i])))
        ds = [d] + ds[:order - 1]
        x = x + sum(float(c) * dj for c, dj in zip(coeffs, ds))
    return x


def _sigma_fn(t):
    return np.exp(-t)


def _t_fn(sigma):
    return -np.log(sigma)


def sample_dpmpp_2s_ancestral(denoise: Callable, x: torch.Tensor, sigmas,
                              eta: float = 1.0, s_noise: float = 1.0,
                              noise_sampler: Optional[Callable] = None,
                              generator: Optional[torch.Generator] = None):
    """DPM-Solver++(2S) ancestral (ref: k_diffusion/sampling.py:507-537;
    `kdip_tpu` samplers.py:319-352)."""
    sig = _host_sigmas(sigmas)
    ns = _noise_sampler(x, noise_sampler, generator)
    r = F32(0.5)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise(x, float(sigma))
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta)
        if sigma_down == 0:
            d = to_d(x, float(sigma), denoised)
            x = x + d * float(sigma_down - sigma)
        else:
            t, t_next = _t_fn(sigma), _t_fn(sigma_down)
            h = t_next - t
            s = t + r * h
            x_2 = (float(_sigma_fn(s) / _sigma_fn(t)) * x
                   - float(np.expm1(-h * r)) * denoised)
            denoised_2 = denoise(x_2, float(_sigma_fn(s)))
            x = (float(_sigma_fn(t_next) / _sigma_fn(t)) * x
                 - float(np.expm1(-h)) * denoised_2)
        if sigma_next > 0:
            x = x + ns(sigma, sigma_next) * float(F32(s_noise)) * float(
                sigma_up)
    return x


def sample_dpmpp_sde(denoise: Callable, x: torch.Tensor, sigmas,
                     eta: float = 1.0, s_noise: float = 1.0,
                     noise_sampler: Optional[Callable] = None,
                     r: float = 1 / 2,
                     generator: Optional[torch.Generator] = None):
    """DPM-Solver++ (stochastic), two calls a step, an Euler step when
    sigma_next is 0 (ref: k_diffusion/sampling.py:541-579; `kdip_tpu`
    samplers.py:355-403). Noise from `noise_sampler`, else a Brownian tree
    seeded from `generator`; each step queries it twice."""
    sig = _host_sigmas(sigmas)
    ns = _tree_sampler(x, sig, noise_sampler, generator)
    r, fac = F32(r), 1 / (2 * r)
    c_old, c_new = float(F32(1 - fac)), float(F32(fac))
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise(x, float(sigma))
        if sigma_next == 0:
            x = x + to_d(x, float(sigma), denoised) * float(sigma_next - sigma)
            continue
        t, t_next = _t_fn(sigma), _t_fn(sigma_next)
        h = t_next - t
        s = t + h * r
        # step 1
        sd, su = get_ancestral_step(_sigma_fn(t), _sigma_fn(s), eta)
        s_ = _t_fn(sd)
        x_2 = (float(_sigma_fn(s_) / _sigma_fn(t)) * x
               - float(np.expm1(t - s_)) * denoised)
        x_2 = x_2 + ns(_sigma_fn(t), _sigma_fn(s)) * float(F32(s_noise)) \
            * float(su)
        denoised_2 = denoise(x_2, float(_sigma_fn(s)))
        # step 2
        sd, su = get_ancestral_step(_sigma_fn(t), _sigma_fn(t_next), eta)
        t_next_ = _t_fn(sd)
        denoised_d = c_old * denoised + c_new * denoised_2
        x = (float(_sigma_fn(t_next_) / _sigma_fn(t)) * x
             - float(np.expm1(t - t_next_)) * denoised_d)
        x = x + ns(_sigma_fn(t), _sigma_fn(t_next)) * float(F32(s_noise)) \
            * float(su)
    return x


def sample_dpmpp_2m_sde(denoise: Callable, x: torch.Tensor, sigmas,
                        eta: float = 1.0, s_noise: float = 1.0,
                        noise_sampler: Optional[Callable] = None,
                        solver_type: str = "midpoint",
                        generator: Optional[torch.Generator] = None):
    """DPM-Solver++(2M) SDE, `heun` or `midpoint` correction; the last step
    (sigma_next 0) returns the denoised x (ref: k_diffusion/sampling.py:
    609-649; `kdip_tpu` samplers.py:452-503). Noise as sample_dpmpp_sde's,
    one query a step."""
    if solver_type not in {"heun", "midpoint"}:
        raise ValueError("solver_type must be 'heun' or 'midpoint'")
    sig = _host_sigmas(sigmas)
    ns = _tree_sampler(x, sig, noise_sampler, generator)
    eta, one = F32(eta), F32(1)
    old_denoised, h_last = None, one
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise(x, float(sigma))
        if sigma_next == 0:
            x, h_last = denoised, F32(0)
        else:
            t, s = -np.log(sigma), -np.log(sigma_next)
            h = s - t
            eta_h = eta * h
            x_new = (float(sigma_next / sigma * np.exp(-eta_h)) * x
                     - float(np.expm1(-h - eta_h)) * denoised)
            if i > 0:
                r_ = h_last / h
                if solver_type == "heun":
                    corr = (np.expm1(-h - eta_h) / (-h - eta_h) * F32(-1)
                            + one) * (one / r_)
                else:
                    corr = F32(0.5) * -np.expm1(-h - eta_h) * (one / r_)
                x_new = x_new + float(corr) * (denoised - old_denoised)
            noise_scale = sigma_next * np.sqrt(-np.expm1(F32(-2) * eta_h))
            x = x_new + ns(sigma, sigma_next) * float(noise_scale) * float(
                F32(s_noise))
            h_last = h
        old_denoised = denoised
    return x


# ---------------------------------------------------------------------------
# DPM-Solver, fast and adaptive, in log-SNR time t = -log(sigma)
# (ref: k_diffusion/sampling.py:331-503; `kdip_tpu` samplers.py:506-832).
# Each step returns (x, cache): the denoiser's eps at t and at the first
# stage, which the adaptive pair shares as the reference's eps_cache does.
# ---------------------------------------------------------------------------

def _dpm_eps(denoise: Callable, x: torch.Tensor, t) -> torch.Tensor:
    sigma = float(np.exp(-F32(t)))
    return (x - denoise(x, sigma)) / sigma


def _dpm_solver_1_step(denoise, x, t, t_next, cache=None):
    t, t_next = F32(t), F32(t_next)
    cache = dict(cache or {})
    h = t_next - t
    if "eps" not in cache:
        cache["eps"] = _dpm_eps(denoise, x, t)
    x_1 = x - float(np.exp(-t_next) * np.expm1(h)) * cache["eps"]
    return x_1, cache


def _dpm_solver_2_step(denoise, x, t, t_next, r1: float = 1 / 2, cache=None):
    t, t_next = F32(t), F32(t_next)
    cache = dict(cache or {})
    h = t_next - t
    if "eps" not in cache:
        cache["eps"] = _dpm_eps(denoise, x, t)
    eps = cache["eps"]
    s1 = t + F32(r1) * h
    u1 = x - float(np.exp(-s1) * np.expm1(F32(r1) * h)) * eps
    if "eps_r1" not in cache:
        cache["eps_r1"] = _dpm_eps(denoise, u1, s1)
    x_2 = (x - float(np.exp(-t_next) * np.expm1(h)) * eps
           - float(np.exp(-t_next) / F32(2 * r1) * np.expm1(h))
           * (cache["eps_r1"] - eps))
    return x_2, cache


def _dpm_solver_3_step(denoise, x, t, t_next, r1: float = 1 / 3,
                       r2: float = 2 / 3, cache=None):
    t, t_next = F32(t), F32(t_next)
    cache = dict(cache or {})
    h = t_next - t
    if "eps" not in cache:
        cache["eps"] = _dpm_eps(denoise, x, t)
    eps = cache["eps"]
    s1, s2 = t + F32(r1) * h, t + F32(r2) * h
    u1 = x - float(np.exp(-s1) * np.expm1(F32(r1) * h)) * eps
    if "eps_r1" not in cache:
        cache["eps_r1"] = _dpm_eps(denoise, u1, s1)
    r2h = F32(r2) * h
    u2 = (x - float(np.exp(-s2) * np.expm1(r2h)) * eps
          - float(np.exp(-s2) * F32(r2 / r1) * (np.expm1(r2h) / r2h - F32(1)))
          * (cache["eps_r1"] - eps))
    eps_r2 = _dpm_eps(denoise, u2, s2)
    x_3 = (x - float(np.exp(-t_next) * np.expm1(h)) * eps
           - float(np.exp(-t_next) / F32(r2) * (np.expm1(h) / h - F32(1)))
           * (eps_r2 - eps))
    return x_3, cache


_DPM_STEPS = {1: _dpm_solver_1_step, 2: _dpm_solver_2_step,
              3: _dpm_solver_3_step}


def sample_dpm_fast(denoise: Callable, x: torch.Tensor, sigma_min: float,
                    sigma_max: float, n: int, eta: float = 0.0,
                    s_noise: float = 1.0, noise_fn: Optional[Callable] = None,
                    generator: Optional[torch.Generator] = None):
    """DPM-Solver-Fast, n denoiser calls in steps of order 3, then 2 and 1
    (ref: k_diffusion/sampling.py:386-423, 480-488; `kdip_tpu`
    samplers.py:552-583). With eta, step i's noise is noise_fn(i), else
    drawn from `generator`."""
    if sigma_min <= 0 or sigma_max <= 0:
        raise ValueError("sigma_min and sigma_max must both be nonzero")
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    m = n // 3 + 1
    ts = np.linspace(t_start, t_end, m + 1).astype(np.float32)
    if n % 3 == 0:
        orders = [3] * (m - 2) + [2, 1]
    else:
        orders = [3] * (m - 1) + [n % 3]
    for i, order in enumerate(orders):
        t, t_next = ts[i], ts[i + 1]
        if eta:
            sd, su = get_ancestral_step(np.exp(-t), np.exp(-t_next), eta)
            t_next_ = np.minimum(F32(t_end), -np.log(sd))
            su = np.sqrt(np.maximum(np.exp(-t_next) ** 2
                                    - np.exp(-t_next_) ** 2, F32(0)))
        else:
            t_next_, su = t_next, F32(0)
        x, _ = _DPM_STEPS[order](denoise, x, t, t_next_)
        if eta:
            noise = noise_fn(i) if noise_fn is not None else _randn(
                x, generator)
            x = x + float(su * F32(s_noise)) * noise
    return x


class PIDStepSizeController:
    """PID controller for adaptive step sizing (ref: k_diffusion/
    sampling.py:302-328); on the host."""

    def __init__(self, h, pcoeff, icoeff, dcoeff, order=1,
                 accept_safety=0.81, eps=1e-8):
        self.h = h
        self.b1 = (pcoeff + icoeff + dcoeff) / order
        self.b2 = -(pcoeff + 2 * dcoeff) / order
        self.b3 = dcoeff / order
        self.accept_safety = accept_safety
        self.eps = eps
        self.errs = []

    def limiter(self, x):
        return 1 + math.atan(x - 1)

    def propose_step(self, error):
        inv_error = 1 / (float(error) + self.eps)
        if not self.errs:
            self.errs = [inv_error, inv_error, inv_error]
        self.errs[0] = inv_error
        factor = (self.errs[0] ** self.b1 * self.errs[1] ** self.b2
                  * self.errs[2] ** self.b3)
        factor = self.limiter(factor)
        accept = factor >= self.accept_safety
        if accept:
            self.errs[2] = self.errs[1]
            self.errs[1] = self.errs[0]
        self.h *= factor
        return accept


def sample_dpm_adaptive(denoise: Callable, x: torch.Tensor, sigma_min: float,
                        sigma_max: float, order: int = 3, rtol: float = 0.05,
                        atol: float = 0.0078, h_init: float = 0.05,
                        pcoeff: float = 0.0, icoeff: float = 1.0,
                        dcoeff: float = 0.0, accept_safety: float = 0.81,
                        eta: float = 0.0, s_noise: float = 1.0,
                        return_info: bool = False,
                        noise_fn: Optional[Callable] = None,
                        generator: Optional[torch.Generator] = None):
    """DPM-Solver-12/23 adaptive (ref: k_diffusion/sampling.py:425-503;
    `kdip_tpu` samplers.py:776-832): a low/high-order pair a step sharing
    its first stages, the error read to the host, the PID controller's
    accept/reject there. info: steps, nfe (order a step, as the reference
    counts them; the denoiser is called order a step), n_accept, n_reject.
    With eta, an accepted step's noise is noise_fn(step), else drawn from
    `generator`."""
    if sigma_min <= 0 or sigma_max <= 0:
        raise ValueError("sigma_min and sigma_max must both be nonzero")
    if order not in {2, 3}:
        raise ValueError("order should be 2 or 3")
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    s = t_start
    x_prev = x
    pid = PIDStepSizeController(abs(h_init), pcoeff, icoeff, dcoeff,
                                1.5 if eta else order, accept_safety)
    info = {"steps": 0, "nfe": 0, "n_accept": 0, "n_reject": 0}
    while s < t_end - 1e-5:
        t = min(t_end, s + pid.h)
        if eta:
            sd, su = get_ancestral_step(math.exp(-s), math.exp(-t), eta)
            t_ = min(t_end, float(-np.log(sd)))
            su = np.sqrt(np.maximum(F32(math.exp(-t) ** 2
                                        - math.exp(-t_) ** 2), F32(0)))
        else:
            t_, su = t, F32(0)
        if order == 2:
            x_low, cache = _dpm_solver_1_step(denoise, x, s, t_)
            x_high, _ = _dpm_solver_2_step(denoise, x, s, t_, cache=cache)
        else:
            x_low, cache = _dpm_solver_2_step(denoise, x, s, t_, r1=1 / 3)
            x_high, _ = _dpm_solver_3_step(denoise, x, s, t_, cache=cache)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()),
                            min=atol)
        error = float(torch.linalg.vector_norm((x_low - x_high) / delta)
                      / x.numel() ** 0.5)
        if pid.propose_step(error):
            x_prev = x_low
            x = x_high
            if eta:
                noise = (noise_fn(info["steps"]) if noise_fn is not None
                         else _randn(x, generator))
                x = x + float(su * F32(s_noise)) * noise
            s = t
            info["n_accept"] += 1
        else:
            info["n_reject"] += 1
        info["nfe"] += order
        info["steps"] += 1
    if return_info:
        return x, info
    return x


# ---------------------------------------------------------------------------
# Probability-flow log-likelihood (ref: k_diffusion/sampling.py:279-299;
# `kdip_tpu` samplers.py:586-742)
# ---------------------------------------------------------------------------

class _Divergence:
    """The ODE's right-hand side d(x, sigma) = (x - D(x, sigma)) / sigma and
    Hutchinson's estimate v . (dd/dx v) of its divergence, one vjp with the
    fixed probe v; counts its calls."""

    def __init__(self, denoise: Callable, v: torch.Tensor):
        self.denoise, self.v, self.calls = denoise, v, 0

    def __call__(self, x, sigma):
        self.calls += 1
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            d = to_d(xx, float(sigma), self.denoise(xx, float(sigma)))
            (grad,) = torch.autograd.grad(d, xx, self.v)
        d_ll = (self.v * grad).reshape(x.shape[0], -1).sum(dim=1)
        return d.detach(), d_ll


def _prior_logpdf(latent: torch.Tensor, sigma_max: float) -> torch.Tensor:
    """sum of log N(latent; 0, sigma_max^2) over each sample, float32, as
    jax.scipy.stats.norm.logpdf computes it."""
    var = F32(sigma_max) ** 2
    log_norm = float(np.log(F32(2 * np.pi) * var))
    logpdf = -(log_norm + latent ** 2 / float(var)) / 2
    return logpdf.reshape(latent.shape[0], -1).sum(dim=1)


def _probe(x, probe, generator):
    return probe if probe is not None else rademacher(
        x.shape, generator=generator, device=x.device)


def log_likelihood(denoise: Callable, x: torch.Tensor, sigma_min: float,
                   sigma_max: float, steps: int = 100,
                   probe: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Log-likelihood of x [B, ...] under the probability-flow ODE from
    sigma_min to sigma_max, fixed-step RK4 in log sigma with a fixed
    Rademacher Hutchinson probe (`probe`, else drawn from `generator`), as
    `kdip_tpu` computes it (samplers.py:586-637; the reference runs
    dopri5). Returns (ll [B], {"fevals": 4 * steps}), each feval a forward
    and a vjp."""
    f = _Divergence(denoise, _probe(x, probe, generator))
    t0, t1 = math.log(sigma_min), math.log(sigma_max)
    h = t1 - t0
    h = h / steps
    hf, h2 = F32(h), F32(h / 2)
    ts = F32(t0) + hf * np.arange(steps, dtype=np.float32)

    def rhs(x, t):
        sigma = np.exp(t)
        d, d_ll = f(x, sigma)
        return d * float(sigma), d_ll * float(sigma)

    ll = torch.zeros(x.shape[0], device=x.device, dtype=x.dtype)
    for t in ts:
        k1x, k1l = rhs(x, t)
        k2x, k2l = rhs(x + float(h2) * k1x, t + h2)
        k3x, k3l = rhs(x + float(h2) * k2x, t + h2)
        k4x, k4l = rhs(x + float(hf) * k3x, t + hf)
        x = x + float(F32(h / 6)) * (k1x + 2 * k2x + 2 * k3x + k4x)
        ll = ll + float(F32(h / 6)) * (k1l + 2 * k2l + 2 * k3l + k4l)
    return _prior_logpdf(x, sigma_max) + ll, {"fevals": 4 * steps}


# Dormand-Prince 5(4) tableau (the reference's torchdiffeq dopri5,
# sampling.py:296)
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def log_likelihood_adaptive(denoise: Callable, x: torch.Tensor,
                            sigma_min: float, sigma_max: float,
                            atol: float = 1e-4, rtol: float = 1e-4,
                            max_steps: int = 1000,
                            probe: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None):
    """log_likelihood with dopri5 error control in sigma (ref: k_diffusion/
    sampling.py:279-299; `kdip_tpu` samplers.py:657-742): the embedded 5(4)
    error's RMS over (x, ll), accepted at <= 1, h *= clip(0.9 err^-1/5,
    0.2, 10), FSAL reuse of the last stage, at most `max_steps` attempts.
    The loop and its error read run on the host. Returns (ll [B],
    {"fevals", "steps"})."""
    f = _Divergence(denoise, _probe(x, probe, generator))
    t1 = F32(sigma_max)
    n = x.numel() + x.shape[0]

    def axpy(y, ks, coeffs, h):
        out = list(y)
        for c, k in zip(coeffs, ks):
            if c != 0.0:
                out = [a + float(h * F32(c)) * b for a, b in zip(out, k)]
        return out

    y = [x, torch.zeros(x.shape[0], device=x.device, dtype=x.dtype)]
    t = F32(sigma_min)
    f_prev = f(x, t)
    h = F32((float(sigma_max) - float(sigma_min)) / 100.0)
    fevals, steps = 1, 0
    while t < t1 and steps < max_steps:
        h = min(h, t1 - t)
        ks = [f_prev]
        for i in range(1, 7):
            yi = axpy(y, ks, _DP_A[i], h)
            ks.append(f(yi[0], t + F32(_DP_C[i]) * h))
        y5 = axpy(y, ks, _DP_B5, h)
        total = 0.0
        for leaf in range(2):
            err = sum(float(F32(b5 - b4)) * k[leaf] for b5, b4, k
                      in zip(_DP_B5, _DP_B4, ks) if b5 != b4) * float(h)
            scale = atol + rtol * torch.maximum(y[leaf].abs(),
                                                y5[leaf].abs())
            total = total + ((err / scale) ** 2).sum()
        norm = F32(torch.sqrt(total / n).item())
        factor = F32(np.clip(F32(0.9) * (norm if norm > 0 else F32(1e-10))
                             ** F32(-0.2), 0.2, 10.0))
        if norm <= 1.0:
            t, y, f_prev = t + h, y5, ks[6]
        h = h * factor
        fevals += 6
        steps += 1
    return _prior_logpdf(y[0], sigma_max) + y[1], {"fevals": fevals,
                                                     "steps": steps}
