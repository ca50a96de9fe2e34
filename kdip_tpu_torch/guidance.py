"""Conditional denoising E[x0 | xt, y] (PyTorch port of `kdip_tpu/guidance.py`;
ref: condition/condition.py).

This slice ports Type-I guidance (and the unguided "uncond" mode) for the
OpenAI ADM models, with the Convert covariance (V1) and the learned
DWT/spatial covariance heads (V2), and the inpainting likelihood solve.

Differences of form from `kdip_tpu`, not of result:
- sigma is a host-side float, so the mle-threshold switch
  (`lax.cond(sigma < mle_sigma_thres)`, guidance.py:637) is a Python `if`,
  and the closed-form branch never computes the covariance tensors;
- the CG loop runs on the host, testing its stopping rule after every
  iteration, which reads the residual back from the device;
- the likelihood score is `torch.autograd.grad` of x0_mean at x.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import diffusion as diff
from . import precond
from .operators import InpaintingOperator, Measurement
from .ops.transforms import OrthoTransform

_LATER = "is not ported yet: a later slice of the PyTorch port (ROADMAP queue 1)"


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Guidance configuration (ref: condition.py:44-71; the fields of
    `kdip_tpu.guidance.GuidanceConfig` that this slice uses). cg_maxiter
    None is the reference's 1000-iteration budget; CG stops once
    |r|^2 <= cg_tol^2 |b|^2."""
    guidance: str = "I"
    x0_cov_type: str = "convert"
    mle_sigma_thres: float = 0.2
    ortho_tf_type: Optional[str] = None
    cg_tol: float = 1e-4
    cg_maxiter: Optional[int] = None


def resolved_cg_maxiter(cfg: GuidanceConfig) -> int:
    return 1000 if cfg.cg_maxiter is None else cfg.cg_maxiter


def _f32(v) -> float:
    """A host scalar rounded to float32, as `kdip_tpu` computes its scalars."""
    return float(np.float32(v))


def mle_var(sigma):
    """High-sigma fallback variance sigma^2/(1+sigma^2) (ref: condition.py:248)."""
    sigma = np.float32(sigma)
    return float(sigma ** 2 / (np.float32(1) + sigma ** 2))


def _model_t(log_sigmas_host: torch.Tensor, sigma: float) -> torch.Tensor:
    """Fractional model timestep of a host sigma, float32 on the host."""
    return precond.sigma_to_t(log_sigmas_host,
                              torch.tensor(sigma, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Unconditional posterior moments for the OpenAI (ADM) model family
# ---------------------------------------------------------------------------

def make_openai_uncond(model_apply: Callable, tables: diff.DiffusionTables,
                       cfg: GuidanceConfig):
    """uncond_pred of ConditionOpenAIDenoiser (ref: condition.py:231-274).

    model_apply(x_scaled, t_int) -> the raw ADMUNet output (eps + variance
    values, 2C channels). Returns (uncond_pred, x0_var_fn):
    uncond_pred(x, sigma) -> (x0_mean, aux); x0_var_fn(aux, sigma) -> the
    Convert covariance below mle_sigma_thres, mle_var(sigma) above."""
    if cfg.x0_cov_type != "convert":
        raise NotImplementedError(f"covariance {cfg.x0_cov_type!r} {_LATER}")
    log_sigmas = tables.log_sigmas.cpu()

    def uncond_pred(x, sigma):
        _, c_in = precond.eps_scalings(np.float32(sigma))
        # floor, like the reference's .long() (kdip_tpu guidance.py:157)
        t = int(_model_t(log_sigmas, sigma))
        t_b = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        x_in = x * _f32(c_in)
        out = diff.p_mean_variance(tables, model_apply(x_in, t_b), x_in, t_b,
                                   clip_denoised=True)
        return out["pred_xstart"], {"variance": out["variance"], "t": t_b}

    def x0_var_fn(aux, sigma):
        if sigma < cfg.mle_sigma_thres:
            return diff.convert_x0_var(tables, aux["variance"], aux["t"])
        return mle_var(sigma)

    return uncond_pred, x0_var_fn


def make_openai_v2_uncond(model_apply: Callable, tables: diff.DiffusionTables,
                          cfg: GuidanceConfig):
    """uncond_pred of ConditionOpenAIDenoiserV2 (ref: condition.py:287-300).

    model_apply(x_scaled, t) -> (eps, logvar, logvar_ot), the ADMUNetV2
    forward. x0_var_fn(aux, sigma) -> (x0_var, theta0_var): the learned
    variances below mle_sigma_thres, mle_var(sigma) above."""
    log_sigmas = tables.log_sigmas.cpu()

    def uncond_pred(x, sigma):
        c_out, c_in = precond.eps_scalings(np.float32(sigma))
        t = _model_t(log_sigmas, sigma).to(x.device)
        eps, logvar, logvar_ot = model_apply(x * _f32(c_in),
                                             t.expand(x.shape[0]))
        x0_mean = eps * _f32(c_out) + x
        return x0_mean, {"logvar": logvar, "logvar_ot": logvar_ot}

    def x0_var_fn(aux, sigma):
        if sigma < cfg.mle_sigma_thres:
            c_out2 = _f32(np.float32(sigma) ** 2)
            return (torch.exp(aux["logvar"]).to(torch.float32) * c_out2,
                    torch.exp(aux["logvar_ot"]).to(torch.float32) * c_out2)
        return mle_var(sigma), mle_var(sigma)

    return uncond_pred, x0_var_fn


# ---------------------------------------------------------------------------
# Likelihood solves: v = (sigma_s^2 I + A Sigma A^T)^{-1} (y - A x0_mean)
# ---------------------------------------------------------------------------

def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _cg_with_residual(matvec, b: torch.Tensor, tol: float, maxiter: int):
    """Conjugate gradients from x0 = 0 in the update order of
    jax.scipy.sparse.linalg.cg (`kdip_tpu` guidance.py:268-311), stopping
    once rs = |r|^2 <= tol^2 |b|^2 or after maxiter iterations. The test
    reads rs on the host after every iteration. Returns
    (x, rs, atol2, iterations), rs and atol2 as 0-d device tensors."""
    bs = _vdot(b, b)
    atol2 = torch.tensor(tol, dtype=b.dtype, device=b.device).square() * bs
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    gamma = _vdot(r, r)
    k = 0
    while k < maxiter and bool(gamma > atol2):
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = _vdot(r, r)
        p = r + (gamma_ / gamma) * p
        gamma = gamma_
        k += 1
    return x, gamma, atol2, k


def _cg(matvec, b, cfg: GuidanceConfig):
    """CG returning (x, rel_resid, iterations) with rel_resid = |r|/|b| at
    exit as a host float (0 for b == 0) (`kdip_tpu` guidance.py:327-352)."""
    x, rs, atol2, k = _cg_with_residual(matvec, b, cfg.cg_tol,
                                        resolved_cg_maxiter(cfg))
    bs = atol2 / torch.tensor(cfg.cg_tol, dtype=rs.dtype).square()
    rel = torch.sqrt(rs / bs.clamp(min=torch.finfo(rs.dtype).tiny))
    return x, float(rel), k


def inpainting_mat(op: InpaintingOperator, y, x0_mean, theta0_var, ortho_tf,
                   iso: bool, cfg: GuidanceConfig):
    """(ref: condition.py:317-348) Returns (mat, rel_resid, cg_iterations)."""
    mask = op.mask
    sigma_s2 = _f32(max(np.float32(op.sigma_s), np.float32(0.001)) ** 2)
    b = mask * y - mask * x0_mean
    if iso:
        return b / _f32(np.float32(sigma_s2) + np.float32(theta0_var)), 0.0, 0

    def matvec(v):  # sigma_s2 v + mask W^-1(theta0_var W v), fused
        return ortho_tf.masked_cov_matvec(v, theta0_var, mask, sigma_s2)

    return _cg(matvec, b, cfg)


def mat_solver(op, y, x0_mean, theta0_var, ortho_tf, iso: bool,
               cfg: GuidanceConfig):
    """Registry dispatch on the operator (ref: condition.py:307-314)."""
    if op.name == "inpainting":
        return inpainting_mat(op, y, x0_mean, theta0_var, ortho_tf, iso, cfg)
    raise NotImplementedError(f"the {op.name!r} likelihood solve {_LATER}")


# ---------------------------------------------------------------------------
# The condition denoiser
# ---------------------------------------------------------------------------

def make_condition_denoiser(uncond_pred: Callable, x0_var_fn: Callable,
                            operator, measurement: Measurement,
                            cfg: GuidanceConfig, v2: bool = False,
                            with_info: bool = False,
                            ortho_tf: Optional[OrthoTransform] = None):
    """Builds `denoise(x, sigma) -> hat_x0` (ref: condition.py:83-131) for
    guidance "I" and "uncond"; sigma is a host float. With with_info it
    returns (hat_x0, info): info["cg_resid"] is the CG relative residual
    |r|/|b| at exit (0.0 for closed-form solves), info["cg_iters"] its
    iteration count. `ortho_tf` replaces the transform named by
    cfg.ortho_tf_type (a test's fake)."""
    if ortho_tf is None:
        ortho_tf = OrthoTransform(cfg.ortho_tf_type)
    y = measurement.y
    if cfg.guidance not in ("I", "uncond"):
        raise NotImplementedError(f"guidance {cfg.guidance!r} {_LATER}")
    if not v2 and cfg.x0_cov_type != "convert":
        raise NotImplementedError(f"covariance {cfg.x0_cov_type!r} {_LATER}")

    def type_I(x, sigma):
        """ref: condition.py:167-174. The covariance switches between the
        CG solve with the model's covariance (below mle_sigma_thres) and the
        closed form at mle_var(sigma) (above)."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            x0_mean, aux = uncond_pred(x, sigma)
        x0m = x0_mean.detach()
        if sigma < cfg.mle_sigma_thres:
            var = x0_var_fn(aux, sigma)
            x0_var, theta0_var = var if v2 else (var, var)
            # ref: condition.py:170-171 - theta0_var in the ortho basis if set
            svar = x0_var if cfg.ortho_tf_type is None else theta0_var
            mat, resid, iters = mat_solver(operator, y, x0m, svar.detach(),
                                           ortho_tf, False, cfg)
        else:
            mat, resid, iters = mat_solver(operator, y, x0m, mle_var(sigma),
                                           ortho_tf, True, cfg)
        score, = torch.autograd.grad(x0_mean, x, grad_outputs=mat)
        return x0m + _f32(np.float32(sigma) ** 2) * score, resid, iters

    def uncond(x, sigma):
        with torch.no_grad():
            return uncond_pred(x, sigma)[0], 0.0, 0

    fn = type_I if cfg.guidance == "I" else uncond

    def denoise(x, sigma):
        out, resid, iters = fn(x, float(sigma))
        out = out.clamp(-1, 1)
        if with_info:
            return out, {"cg_resid": resid, "cg_iters": iters}
        return out

    return denoise
