"""Noise-level (sigma) schedules and ODE helpers (PyTorch port of
`kdip_tpu/schedules.py`; ref: k_diffusion/sampling.py:13-58).

The schedules are float32 and default to the CPU: samplers read them on
the host to drive their loop."""

from __future__ import annotations

import math

import numpy as np
import torch


def append_zero(x: torch.Tensor) -> torch.Tensor:
    """Appends a final zero sigma (ref: k_diffusion/sampling.py:13)."""
    return torch.cat([x, x.new_zeros([1])])


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0, device="cpu") -> torch.Tensor:
    """Noise schedule of Karras et al. (2022), float32
    (ref: k_diffusion/sampling.py:17-23). The schedule defaults to the CPU:
    samplers read it on the host to drive their loop."""
    ramp = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return append_zero(sigmas)


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Appends trailing singleton dims until `x.ndim == target_ndim`
    (ref: k_diffusion/utils.py:40-46)."""
    dims_to_append = target_ndim - x.ndim
    if dims_to_append < 0:
        raise ValueError(f"input has {x.ndim} dims but target_ndim is "
                         f"{target_ndim}, which is less")
    return x[(...,) + (None,) * dims_to_append]


def to_d(x: torch.Tensor, sigma, denoised: torch.Tensor) -> torch.Tensor:
    """Denoiser output -> Karras ODE derivative
    (ref: k_diffusion/sampling.py:46-48). `sigma` is a host scalar or a
    tensor broadcastable after `append_dims`."""
    if isinstance(sigma, torch.Tensor):
        sigma = append_dims(sigma, x.ndim)
    return (x - denoised) / sigma


def get_sigmas_exponential(n: int, sigma_min: float, sigma_max: float,
                           device="cpu") -> torch.Tensor:
    """Exponential noise schedule, float32 (ref: k_diffusion/sampling.py:
    26-29)."""
    sigmas = torch.exp(torch.linspace(math.log(sigma_max),
                                      math.log(sigma_min), n,
                                      dtype=torch.float32, device=device))
    return append_zero(sigmas)


def get_sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float,
                               rho: float = 1.0, device="cpu"
                               ) -> torch.Tensor:
    """Polynomial-in-log-sigma schedule, float32 (ref:
    k_diffusion/sampling.py:32-36)."""
    ramp = torch.linspace(1, 0, n, dtype=torch.float32, device=device) ** rho
    sigmas = torch.exp(ramp * (math.log(sigma_max) - math.log(sigma_min))
                       + math.log(sigma_min))
    return append_zero(sigmas)


def get_sigmas_vp(n: int, beta_d: float = 19.9, beta_min: float = 0.1,
                  eps_s: float = 1e-3, device="cpu") -> torch.Tensor:
    """Continuous VP noise schedule, float32 (ref: k_diffusion/sampling.py:
    39-43)."""
    t = torch.linspace(1, eps_s, n, dtype=torch.float32, device=device)
    sigmas = torch.sqrt(torch.exp(beta_d * t ** 2 / 2 + beta_min * t) - 1)
    return append_zero(sigmas)


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """(sigma_down, sigma_up) of an ancestral step (ref:
    k_diffusion/sampling.py:51-58), as float32 host scalars (numpy; arrays
    work elementwise): the samplers decide `sigma_down == 0` on the host."""
    sigma_from = np.float32(sigma_from)
    sigma_to = np.float32(sigma_to)
    if not eta:
        return sigma_to, np.float32(0)
    sigma_up = np.minimum(sigma_to, np.float32(eta) * (
        sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2) / sigma_from ** 2
    ) ** np.float32(0.5))
    sigma_down = (sigma_to ** 2 - sigma_up ** 2) ** np.float32(0.5)
    return sigma_down, sigma_up
