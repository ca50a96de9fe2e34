"""Discrete DDPM coefficient tables, respacing and posterior math (PyTorch
port of `kdip_tpu/diffusion.py`; ref: guided_diffusion/gaussian_diffusion.py
and respace.py).

The tables are built in float64 numpy, as the reference builds them, and
stored as float32 tensors on the caller's device. NCHW layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str,
                            num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedules, float64 numpy (ref: gaussian_diffusion.py:18-42)."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02,
                           num_diffusion_timesteps, dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unrecognized beta schedule {schedule_name!r}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    """Discretizes an alpha_bar function into betas, float64
    (ref: gaussian_diffusion.py:45-62)."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> set:
    """The original timesteps a respaced run keeps (ref: respace.py:7-60).

    `section_counts` is a comma-separated count string (one count per
    equal-length section of the schedule), "ddimN" (the stride that keeps
    exactly N steps) or a sequence of ints. A section's positions are
    accumulated (stride added count - 1 times, np.add.accumulate) and then
    rounded half to even, which is the index set published configs pin:
    where a multiple of the stride is an exact x.5, the accumulated float
    lands a hair off it and rounds the other way than a product would."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            want = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if -(-num_timesteps // stride) == want:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"no integer stride over {num_timesteps} timesteps keeps "
                f"exactly {want} DDIM steps")
        section_counts = [int(x) for x in section_counts.split(",")]
    base_len, leftover = divmod(num_timesteps, len(section_counts))
    chosen: set = set()
    offset = 0
    for i, count in enumerate(section_counts):
        length = base_len + (1 if i < leftover else 0)
        if count > length:
            raise ValueError(
                f"section {i} spans only {length} timesteps — too few to "
                f"pick {count} distinct steps from")
        if count >= 2:
            pos = np.empty(count)
            pos[0] = 0.0
            np.add.accumulate(np.full(count - 1, (length - 1) / (count - 1)),
                              out=pos[1:])
            chosen.update(int(offset + p) for p in np.round(pos))
        elif count == 1:
            chosen.add(offset)
        offset += length
    return chosen


class DiffusionTables(NamedTuple):
    """Precomputed DDPM coefficient tables, each [T] float32
    (gaussian_diffusion.py:133-169), the EDM sigmas of each timestep and
    their logs (ref: k_diffusion/external.py:88-93), and the respaced
    index -> original timestep map, int64 (respace.py:72-86)."""
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
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_tables(betas: np.ndarray, timestep_map=None,
                device="cuda") -> DiffusionTables:
    """Builds the coefficient tables from betas in float64 and stores them
    as float32 tensors on `device`; `timestep_map` defaults to the
    identity."""
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod))
    sigmas = np.sqrt((1 - alphas_cumprod) / alphas_cumprod)
    if timestep_map is None:
        timestep_map = np.arange(len(betas))
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
        timestep_map=torch.tensor(np.asarray(timestep_map), dtype=torch.int64,
                                  device=device),
    )


def make_diffusion(steps: int = 1000, noise_schedule: str = "linear",
                   timestep_respacing: Union[str, Sequence[int], None] = None,
                   device="cuda") -> DiffusionTables:
    """Tables of a schedule, respaced when asked (ref: script_util.py:
    386-424, and SpacedDiffusion's beta rewriting, respace.py:77-86)."""
    betas = get_named_beta_schedule(noise_schedule, steps)
    if not timestep_respacing:
        return make_tables(betas, device=device)
    use_timesteps = space_timesteps(steps, timestep_respacing)
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, ac in enumerate(np.cumprod(1.0 - betas)):
        if i in use_timesteps:
            new_betas.append(1 - ac / last_alpha_cumprod)
            last_alpha_cumprod = ac
            timestep_map.append(i)
    return make_tables(np.array(new_betas), np.array(timestep_map),
                       device=device)


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] for integer t [B], with trailing dims appended for
    broadcasting against an `ndim`-dimensional batch tensor
    (ref: gaussian_diffusion.py:895-907)."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def q_sample(tables: DiffusionTables, x_start, t, noise):
    """A draw of q(x_t | x_0) with the given noise
    (ref: gaussian_diffusion.py:188-206)."""
    nd = x_start.ndim
    return (extract(tables.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(tables.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


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


def predict_eps_from_xstart(tables: DiffusionTables, x_t, t, pred_xstart):
    """(ref: gaussian_diffusion.py:345-349)"""
    nd = x_t.ndim
    return ((extract(tables.sqrt_recip_alphas_cumprod, t, nd) * x_t
             - pred_xstart)
            / extract(tables.sqrt_recipm1_alphas_cumprod, t, nd))


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
                    clip_denoised: bool = True, learn_sigma: bool = True,
                    predict_xstart: bool = False, sigma_small: bool = False):
    """p(x_{t-1} | x_t) statistics from a model's raw output
    (ref: gaussian_diffusion.py:232-326). With `learn_sigma`,
    `model_output` is [B, 2C, H, W]: the mean head, then the LEARNED_RANGE
    variance values; without it the variance is FIXED_LARGE, or
    FIXED_SMALL with `sigma_small` (ModelVarType, :75-86). The mean head is
    eps, or x0 with `predict_xstart` (ModelMeanType, :65-71). `t` holds
    the (respaced) integer timesteps [B]. Returns dict(mean, variance,
    log_variance, pred_xstart)."""
    nd = x.ndim
    if learn_sigma:
        C = x.shape[1]
        head, model_var_values = model_output[:, :C], model_output[:, C:]
        variance, log_variance = learned_range_variance(
            tables, model_var_values, t)
    elif sigma_small:
        head = model_output
        variance = extract(tables.posterior_variance, t, nd)
        log_variance = extract(tables.posterior_log_variance_clipped, t, nd)
    else:
        head = model_output
        fixed_large = torch.cat([tables.posterior_variance[1:2],
                                 tables.betas[1:]])
        variance = extract(fixed_large, t, nd)
        log_variance = torch.log(variance)
    if predict_xstart:
        pred_xstart = head
    else:
        pred_xstart = predict_xstart_from_eps(tables, x, t, head)
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


def model_timesteps(tables: DiffusionTables, t,
                    rescale_timesteps: bool = False,
                    original_num_steps: int = 1000) -> torch.Tensor:
    """The float32 timesteps the model is fed for respaced indices `t`:
    timestep_map[t] (ref: respace.py:116-128 _WrappedModel), rescaled to
    0..1000 with `rescale_timesteps` (gaussian_diffusion.py:351-354)."""
    t = tables.timestep_map[torch.as_tensor(
        t, device=tables.timestep_map.device).long()]
    if rescale_timesteps:
        return t.to(torch.float32) * (1000.0 / original_num_steps)
    return t.to(torch.float32)
