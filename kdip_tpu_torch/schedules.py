"""Noise-level (sigma) schedules and ODE helpers (PyTorch port of
`kdip_tpu/schedules.py`; ref: k_diffusion/sampling.py:13-58)."""

from __future__ import annotations

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
