"""Discrete DDPM coefficient tables and posterior math (PyTorch port of
`kdip_tpu/diffusion.py`; ref: guided_diffusion/gaussian_diffusion.py).

The tables are built in float64 numpy, as the reference builds them, and
stored as float32 tensors on the caller's device. NCHW layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str,
                            num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedules, float64 numpy (ref: gaussian_diffusion.py:18-42).
    Only the linear schedule, which every ADM model of this repo uses."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02,
                           num_diffusion_timesteps, dtype=np.float64)
    raise NotImplementedError(f"beta schedule {schedule_name!r} is not ported")


class DiffusionTables(NamedTuple):
    """Precomputed DDPM coefficient tables, each [T] float32
    (gaussian_diffusion.py:133-169), plus the EDM sigmas of each timestep
    and their logs (ref: k_diffusion/external.py:88-93)."""
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    sigmas: torch.Tensor
    log_sigmas: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_tables(betas: np.ndarray, device="cuda") -> DiffusionTables:
    """Builds the coefficient tables from betas in float64 and stores them
    as float32 tensors on `device`."""
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod))
    sigmas = np.sqrt((1 - alphas_cumprod) / alphas_cumprod)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                 device=device)
    return DiffusionTables(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.append(
            posterior_variance[1], posterior_variance[1:]))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev)
                                 / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                 / (1.0 - alphas_cumprod)),
        log_betas=f32(np.log(betas)),
        sigmas=f32(sigmas),
        log_sigmas=f32(np.log(sigmas)),
    )


def make_diffusion(steps: int = 1000, noise_schedule: str = "linear",
                   device="cuda") -> DiffusionTables:
    """Tables of an unrespaced schedule (ref: script_util.py:386-424)."""
    return make_tables(get_named_beta_schedule(noise_schedule, steps),
                       device=device)


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] for integer t [B], with trailing dims appended for
    broadcasting against an `ndim`-dimensional batch tensor
    (ref: gaussian_diffusion.py:895-907)."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def q_posterior_mean_variance(tables: DiffusionTables, x_start, x_t, t):
    """Mean/variance of q(x_{t-1} | x_t, x_0)
    (ref: gaussian_diffusion.py:208-230)."""
    nd = x_t.ndim
    mean = (extract(tables.posterior_mean_coef1, t, nd) * x_start
            + extract(tables.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(tables.posterior_variance, t, nd),
            extract(tables.posterior_log_variance_clipped, t, nd))


def predict_xstart_from_eps(tables: DiffusionTables, x_t, t, eps):
    """(ref: gaussian_diffusion.py:328-333)"""
    nd = x_t.ndim
    return (extract(tables.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(tables.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def learned_range_variance(tables: DiffusionTables, model_var_values, t):
    """LEARNED_RANGE variance (ref: gaussian_diffusion.py:262-276): values in
    [-1, 1] interpolate the log-variance between the clipped posterior
    log-variance and log(beta). Returns (variance, log_variance)."""
    nd = model_var_values.ndim
    min_log = extract(tables.posterior_log_variance_clipped, t, nd)
    max_log = extract(tables.log_betas, t, nd)
    frac = (model_var_values + 1) / 2
    log_variance = frac * max_log + (1 - frac) * min_log
    return torch.exp(log_variance), log_variance


def p_mean_variance(tables: DiffusionTables, model_output, x, t,
                    clip_denoised: bool = True):
    """p(x_{t-1} | x_t) statistics from a learn_sigma eps model's raw output
    (ref: gaussian_diffusion.py:232-326). `model_output` is [B, 2C, H, W]:
    eps, then the LEARNED_RANGE variance values. `t` holds integer
    timesteps [B]. Returns dict(mean, variance, log_variance, pred_xstart)."""
    C = x.shape[1]
    eps, model_var_values = model_output[:, :C], model_output[:, C:]
    variance, log_variance = learned_range_variance(tables, model_var_values, t)
    pred_xstart = predict_xstart_from_eps(tables, x, t, eps)
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1, 1)
    mean, _, _ = q_posterior_mean_variance(tables, pred_xstart, x, t)
    return {"mean": mean, "variance": variance, "log_variance": log_variance,
            "pred_xstart": pred_xstart}


def convert_x0_var(tables: DiffusionTables, model_variance, t):
    """The "Convert" posterior covariance, Eq. (22) of the paper
    (ref: condition/condition.py:241-248):
    (reverse_variance - posterior_variance[t]) / posterior_mean_coef1[t]^2,
    clipped to >= 1e-6."""
    nd = model_variance.ndim
    pv = extract(tables.posterior_variance, t, nd)
    c1 = extract(tables.posterior_mean_coef1, t, nd)
    return ((model_variance - pv) / c1 ** 2).clamp(min=1e-6)
