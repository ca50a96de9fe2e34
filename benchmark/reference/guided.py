"""The guided posterior sampler's mathematics in plain float32 PyTorch and
NumPy, the benchmark's reference for what one guided Heun step computes
(Peng et al. 2024, "Improving Diffusion Models for Inverse Problems Using
Optimal Posterior Covariance", github.com/xypeng9903/k-diffusion-inverse-
problems; k-diffusion's Heun sampler with churn, Karras et al. 2022,
Algorithm 2).

- `Tables`: the 1000-step linear DDPM schedule (float64, kept as float32).
- `Schedule`: the Karras sigmas, the churn and each step's host scalars.
- `haar` / `ihaar`: the packed multi-level orthonormal Haar DWT.
- `guided_x0`: Type-I guidance's x0 estimate, x0_mean + sigma^2 J^T u
  with u = (s^2 I + A Sigma A^T)^-1 (y - A x0_mean), for an inpainting A:
  a joint CG over the batch below the threshold, the closed form at
  sigma^2 / (1 + sigma^2) above it. Sigma is the DWT-Var head's learned
  diagonal in the Haar basis, or the Convert covariance of Eq. 22 from the
  learned DDPM variance.

Nothing here imports the program; the model is `adm.py`'s.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

F32 = np.float32
INV_SQRT2 = 1 / np.sqrt(2.0)


def f32(v) -> float:
    """A host scalar rounded to float32, as the sampler's scalars are."""
    return float(F32(v))


class Tables(NamedTuple):
    log_betas: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    log_sigmas: torch.Tensor       # float32 on the host


def linear_tables(steps: int, device) -> Tables:
    """guided-diffusion's linear schedule (gaussian_diffusion.py:18-30,
    133-169), computed in float64."""
    scale = 1000 / steps
    betas = np.linspace(scale * 1e-4, scale * 0.02, steps, dtype=np.float64)
    acp = np.cumprod(1.0 - betas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)
    return Tables(
        log_betas=t(np.log(betas)),
        posterior_variance=t(post_var),
        posterior_log_variance_clipped=t(np.log(np.append(post_var[1],
                                                          post_var[1:]))),
        posterior_mean_coef1=t(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        sqrt_recip_alphas_cumprod=t(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=t(np.sqrt(1.0 / acp - 1)),
        log_sigmas=torch.tensor(np.log(np.sqrt((1 - acp) / acp)),
                                dtype=torch.float32))


def sigma_to_t(log_sigmas: torch.Tensor, sigma: float) -> float:
    """k-diffusion's interpolated timestep of a sigma (external.py:67-79),
    in float32."""
    ls = torch.log(torch.tensor(sigma, dtype=torch.float32))
    dists = ls - log_sigmas
    low = int(torch.cumsum((dists >= 0).to(torch.int32), 0).argmax()
              .clamp(0, log_sigmas.shape[0] - 2))
    lo, hi = log_sigmas[low], log_sigmas[low + 1]
    w = ((lo - ls) / (lo - hi)).clamp(0, 1)
    return float((1 - w) * low + w * (low + 1))


class Schedule:
    """The sampler's host scalars: Karras sigmas (float32, k-diffusion
    sampling.py:17-23), the churn's gamma, sigma_hat and bump per step."""

    def __init__(self, steps: int, sigma_min: float, sigma_max: float,
                 rho: float, s_churn: float, s_tmin: float, s_tmax: float,
                 s_noise: float):
        ramp = torch.linspace(0, 1, steps, dtype=torch.float32)
        lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
        sig = ((hi + ramp * (lo - hi)) ** rho).numpy()
        self.sigmas = np.append(sig, F32(0)).astype(F32)
        on = (self.sigmas[:-1] >= s_tmin) & (self.sigmas[:-1] <= s_tmax)
        g = F32(min(s_churn / steps, 2 ** 0.5 - 1))
        self.gammas = np.where(on, g, F32(0)).astype(F32)
        self.s_noise = f32(s_noise)
        self.steps = steps

    def sigma_hat(self, i: int):
        return self.sigmas[i] * (self.gammas[i] + F32(1))

    def bump(self, i: int) -> float:
        """The churn's noise scale of step i (0 where gamma is 0)."""
        s, sh = self.sigmas[i], self.sigma_hat(i)
        if self.gammas[i] <= 0:
            return 0.0
        return float(np.sqrt(max(sh ** 2 - s ** 2, F32(0))))

    def call_sigmas(self):
        """The sigma of every guided call of a trajectory, in order: step
        i calls at sigma_hat(i), then at sigma(i+1) unless that is 0."""
        out = []
        for i in range(self.steps):
            out.append(float(self.sigma_hat(i)))
            if self.sigmas[i + 1] != 0:
                out.append(float(self.sigmas[i + 1]))
        return out


def c_in(sigma) -> float:
    """The eps models' input scale 1 / sqrt(sigma^2 + 1), float32."""
    s = F32(sigma)
    return f32(F32(1) / (s ** 2 + F32(1)) ** F32(0.5))


def mle_var(sigma) -> float:
    s = F32(sigma)
    return f32(s ** 2 / (F32(1) + s ** 2))


# ---------------------------------------------------------------------------
# The packed Haar DWT (pywt's coeffs_to_array layout: at each level the
# approximation block becomes [[ll, lh], [hl, hh]])
# ---------------------------------------------------------------------------

def _split(x: torch.Tensor, dim: int):
    even, odd = x.unflatten(dim, (-1, 2)).unbind(dim + 1)
    return (even + odd) * INV_SQRT2, (even - odd) * INV_SQRT2


def _merge(lo: torch.Tensor, hi: torch.Tensor, dim: int):
    even, odd = (lo + hi) * INV_SQRT2, (lo - hi) * INV_SQRT2
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def haar(x: torch.Tensor, level: int) -> torch.Tensor:
    out = x.clone()
    H, W = x.shape[-2:]
    for lv in range(level):
        blk = out[..., :H >> lv, :W >> lv]
        lo, hi = _split(blk, 2)
        ll, lh = _split(lo, 3)
        hl, hh = _split(hi, 3)
        out[..., :H >> lv, :W >> lv] = torch.cat(
            [torch.cat([ll, lh], 3), torch.cat([hl, hh], 3)], 2)
    return out


def ihaar(x: torch.Tensor, level: int) -> torch.Tensor:
    out = x.clone()
    H, W = x.shape[-2:]
    for lv in range(level - 1, -1, -1):
        h, w = H >> (lv + 1), W >> (lv + 1)
        blk = out[..., :2 * h, :2 * w]
        rows = (_merge(blk[..., :h, :w], blk[..., :h, w:], 3),
                _merge(blk[..., h:, :w], blk[..., h:, w:], 3))
        out[..., :2 * h, :2 * w] = _merge(*rows, 2)
    return out


def cg(matvec: Callable, b: torch.Tensor, tol: float, maxiter: int):
    """Conjugate gradients from 0 on the whole batch as one system, until
    |r|^2 <= tol^2 |b|^2 or maxiter iterations. Returns (u, iterations)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r
    gamma = torch.dot(r.flatten(), r.flatten())
    stop = tol ** 2 * gamma
    k = 0
    while k < maxiter and bool(gamma > stop):
        Ap = matvec(p)
        alpha = gamma / torch.dot(p.flatten(), Ap.flatten())
        x = x + alpha * p
        r = r - alpha * Ap
        g2 = torch.dot(r.flatten(), r.flatten())
        p = r + (g2 / gamma) * p
        gamma = g2
        k += 1
    return x, k


# ---------------------------------------------------------------------------
# The guided x0 estimate (Type-I guidance; condition.py:167-174 of the
# source repository)
# ---------------------------------------------------------------------------

def guided_x0(moments: Callable, problem, gcfg: Dict, x: torch.Tensor,
              sigma: float):
    """(hat_x0 clamped to [-1, 1], the model's raw outputs) at (x, sigma)
    for a batch x [B, C, H, W] in float32. `moments(x, sigma)` gives
    (x0_mean on x's graph, theta(), raw): theta() the covariance below the
    threshold, in the basis that gcfg's ortho_tf_type names. `problem` is
    an operator of `op_*.py`; gcfg holds mle_sigma_thres, cg_tol,
    cg_maxiter and ortho_tf_type (None or "dwt", 3 levels)."""
    s2_sig = f32(F32(sigma) ** 2)
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        x0m, theta, raw = moments(xg, sigma)
    b = problem.residual(x0m.detach())
    if sigma < gcfg["mle_sigma_thres"]:
        th = theta()
        if gcfg.get("ortho_tf_type") == "dwt":
            def cov(v):
                return ihaar(th * haar(v, 3), 3)
        else:
            def cov(v):
                return th * v
        u, _ = cg(problem.matvec(cov), b, gcfg["cg_tol"],
                  gcfg["cg_maxiter"])
    else:
        u = problem.closed(b, mle_var(sigma))
    g = torch.autograd.grad(x0m, xg, grad_outputs=problem.adjoint(u))[0]
    return (x0m.detach() + s2_sig * g).clamp(-1, 1), raw
