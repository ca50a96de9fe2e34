"""Denoiser preconditioning for discrete eps models (PyTorch port of
`kdip_tpu/precond.py`; ref: k_diffusion/external.py:67-114)."""

from __future__ import annotations

import torch


def eps_scalings(sigma, sigma_data: float = 1.0):
    """c_out, c_in for discrete eps models (ref: k_diffusion/external.py:97-100)."""
    c_out = -sigma
    c_in = 1 / (sigma ** 2 + sigma_data ** 2) ** 0.5
    return c_out, c_in


def sigma_to_t(log_sigmas: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Continuous interpolated timestep of a sigma
    (ref: k_diffusion/external.py:67-79).

    log_sigmas: [T] ascending log-sigma table. Returns float t with the
    shape of `sigma`. Callers that want the reference's `.long()` cast
    floor the result."""
    log_sigma = torch.log(sigma)
    dists = log_sigma[..., None] - log_sigmas
    T = log_sigmas.shape[0]
    low_idx = torch.cumsum((dists >= 0).to(torch.int32), dim=-1).argmax(
        dim=-1).clamp(0, T - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = ((low - log_sigma) / (low - high)).clamp(0, 1)
    return (1 - w) * low_idx + w * high_idx
