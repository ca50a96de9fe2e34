"""Denoiser preconditioning and model adapters (PyTorch port of
`kdip_tpu/precond.py`; ref: k_diffusion/external.py, k_diffusion/layers.py:
13-84): maps raw network outputs (eps or v) into the continuous-sigma
Karras denoiser `D(x, sigma) -> x0`.

A denoiser factory takes `model_apply(x_scaled, t, **kw)`, the model
closed over, and returns `denoise(x, sigma, **kw)`. `sigma` is a host
scalar, as the samplers pass it (the scalings are then float32 host
numbers and the model's timestep a [B] tensor on x's device), or a tensor
broadcastable against x's batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .schedules import append_dims, append_zero


# ---------------------------------------------------------------------------
# Scalings
# ---------------------------------------------------------------------------

def edm_scalings(sigma, sigma_data: float = 1.0):
    """c_skip, c_out, c_in of Karras et al. (ref: k_diffusion/layers.py:21-25)."""
    c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
    c_out = sigma * sigma_data / (sigma ** 2 + sigma_data ** 2) ** 0.5
    c_in = 1 / (sigma ** 2 + sigma_data ** 2) ** 0.5
    return c_skip, c_out, c_in


def v_scalings(sigma, sigma_data: float = 1.0):
    """Scalings for v-prediction models (ref: k_diffusion/external.py:18-22)."""
    c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
    c_out = -sigma * sigma_data / (sigma ** 2 + sigma_data ** 2) ** 0.5
    c_in = 1 / (sigma ** 2 + sigma_data ** 2) ** 0.5
    return c_skip, c_out, c_in


def eps_scalings(sigma, sigma_data: float = 1.0):
    """c_out, c_in for discrete eps models (ref: k_diffusion/external.py:97-100)."""
    c_out = -sigma
    c_in = 1 / (sigma ** 2 + sigma_data ** 2) ** 0.5
    return c_out, c_in


# ---------------------------------------------------------------------------
# sigma <-> t for discrete schedules
# ---------------------------------------------------------------------------

def sigma_to_t(log_sigmas: torch.Tensor, sigma: torch.Tensor,
               quantize: bool = False) -> torch.Tensor:
    """Continuous interpolated timestep of a sigma
    (ref: k_diffusion/external.py:67-79).

    log_sigmas: [T] ascending log-sigma table. Returns float t with the
    shape of `sigma`, or with `quantize` the nearest table index (int32).
    Callers that want the reference's `.long()` cast floor the float t."""
    log_sigma = torch.log(sigma)
    dists = log_sigma[..., None] - log_sigmas
    if quantize:
        return dists.abs().argmin(dim=-1).to(torch.int32)
    T = log_sigmas.shape[0]
    low_idx = torch.cumsum((dists >= 0).to(torch.int32), dim=-1).argmax(
        dim=-1).clamp(0, T - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = ((low - log_sigma) / (low - high)).clamp(0, 1)
    return (1 - w) * low_idx + w * high_idx


def t_to_sigma(log_sigmas: torch.Tensor, t) -> torch.Tensor:
    """Inverse of sigma_to_t (ref: k_diffusion/external.py:81-85)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=log_sigmas.device)
    low_idx = torch.floor(t).long()
    high_idx = torch.ceil(t).long()
    w = t - torch.floor(t)
    log_sigma = (1 - w) * log_sigmas[low_idx] + w * log_sigmas[high_idx]
    return torch.exp(log_sigma)


# ---------------------------------------------------------------------------
# Denoiser adapters
# ---------------------------------------------------------------------------

def _sigma_terms(scalings: Callable, sigma, x: torch.Tensor):
    """The scalings of `sigma` ready to multiply x: float32 host floats for
    a host scalar, else tensors with x's trailing dims appended."""
    if torch.is_tensor(sigma):
        sigma = sigma.to(device=x.device, dtype=torch.float32)
        return [append_dims(c, x.ndim) for c in scalings(sigma)]
    return [float(c) for c in scalings(np.float32(sigma))]


def _model_t(log_sigmas: torch.Tensor, log_sigmas_host: torch.Tensor, sigma,
             x: torch.Tensor, quantize: bool) -> torch.Tensor:
    """The model's [B] float32 timestep of `sigma` on x's device. A host
    scalar's t is computed on the host (no device read)."""
    if torch.is_tensor(sigma):
        t = sigma_to_t(log_sigmas.to(sigma.device),
                       sigma.to(torch.float32), quantize)
        return t.to(x.device, torch.float32).expand(x.shape[0])
    t = sigma_to_t(log_sigmas_host, torch.tensor(np.float32(sigma)), quantize)
    return torch.full((x.shape[0],), float(t), dtype=torch.float32,
                      device=x.device)


def make_edm_denoiser(model_apply: Callable, sigma_data: float = 1.0
                      ) -> Callable:
    """EDM-preconditioned denoiser (ref: k_diffusion/layers.py:13-36).
    model_apply(x_scaled, sigma, **kw) -> model output."""
    def denoise(x, sigma, **kwargs):
        c_skip, c_out, c_in = _sigma_terms(
            lambda s: edm_scalings(s, sigma_data), sigma, x)
        return model_apply(x * c_in, sigma, **kwargs) * c_out + x * c_skip
    return denoise


def make_v_denoiser(model_apply: Callable, sigma_data: float = 1.0
                    ) -> Callable:
    """v-diffusion denoiser (ref: k_diffusion/external.py:10-39); the model
    takes t = atan(sigma) * 2 / pi."""
    def denoise(x, sigma, **kwargs):
        c_skip, c_out, c_in = _sigma_terms(
            lambda s: v_scalings(s, sigma_data), sigma, x)
        if torch.is_tensor(sigma):
            t = torch.atan(sigma.to(x.device, torch.float32)) / np.pi * 2
        else:
            t = float(np.arctan(np.float32(sigma)) / np.float32(np.pi)
                      * np.float32(2))
        return model_apply(x * c_in, t, **kwargs) * c_out + x * c_skip
    return denoise


def make_discrete_eps_denoiser(model_apply: Callable,
                               log_sigmas: torch.Tensor,
                               quantize: bool = False) -> Callable:
    """Discrete-schedule eps-model denoiser (ref: k_diffusion/external.py:
    88-114). model_apply(x_scaled, t, **kw) -> eps (sliced to the image's
    channels), t a [B] float32 tensor. Also the CompVis adapter's shape
    (external.py:172-179): callers fold `apply_model` into model_apply."""
    log_sigmas_host = log_sigmas.detach().cpu().to(torch.float32)

    def denoise(x, sigma, **kwargs):
        c_out, c_in = _sigma_terms(eps_scalings, sigma, x)
        t = _model_t(log_sigmas, log_sigmas_host, sigma, x, quantize)
        eps = model_apply(x * c_in, t, **kwargs)
        return x + eps * c_out
    return denoise


def make_discrete_v_denoiser(model_apply: Callable, log_sigmas: torch.Tensor,
                             quantize: bool = False,
                             sigma_data: float = 1.0) -> Callable:
    """Discrete-schedule v-prediction denoiser (ref: k_diffusion/
    external.py:182-218, DiscreteVDDPMDenoiser / CompVisVDenoiser)."""
    log_sigmas_host = log_sigmas.detach().cpu().to(torch.float32)

    def denoise(x, sigma, **kwargs):
        c_skip, c_out, c_in = _sigma_terms(
            lambda s: v_scalings(s, sigma_data), sigma, x)
        t = _model_t(log_sigmas, log_sigmas_host, sigma, x, quantize)
        v = model_apply(x * c_in, t, **kwargs)
        return v * c_out + x * c_skip
    return denoise


def sigmas_from_alphas_cumprod(alphas_cumprod) -> torch.Tensor:
    """Discrete sigma table ((1 - abar) / abar) ** 0.5 from a DDPM model's
    alphas_cumprod, float32 (ref: k_diffusion/external.py:92, 185)."""
    a = torch.as_tensor(alphas_cumprod, dtype=torch.float32)
    return ((1 - a) / a) ** 0.5


def make_compvis_eps_denoiser(model_apply: Callable, alphas_cumprod,
                              quantize: bool = False) -> Callable:
    """CompVisDenoiser (ref: k_diffusion/external.py:172-179): a discrete
    eps denoiser whose sigma table comes from alphas_cumprod; conditioning
    passes through **kw."""
    return make_discrete_eps_denoiser(
        model_apply, torch.log(sigmas_from_alphas_cumprod(alphas_cumprod)),
        quantize=quantize)


def make_compvis_v_denoiser(model_apply: Callable, alphas_cumprod,
                            quantize: bool = False) -> Callable:
    """CompVisVDenoiser / DiscreteVDDPMDenoiser (ref: k_diffusion/
    external.py:182-231); sigma_data is 1, as in the reference."""
    return make_discrete_v_denoiser(
        model_apply, torch.log(sigmas_from_alphas_cumprod(alphas_cumprod)),
        quantize=quantize, sigma_data=1.0)


def schedule_sigmas(log_sigmas: torch.Tensor, n: Optional[int] = None
                    ) -> torch.Tensor:
    """Sampling schedule from a discrete sigma table (ref: k_diffusion/
    external.py:60-65 DiscreteSchedule.get_sigmas): descending,
    zero-terminated; interpolated when n is given."""
    if n is None:
        return append_zero(torch.exp(log_sigmas).flip(0))
    t_max = log_sigmas.shape[0] - 1
    t = torch.linspace(t_max, 0, n, dtype=torch.float32,
                       device=log_sigmas.device)
    return append_zero(t_to_sigma(log_sigmas, t))
