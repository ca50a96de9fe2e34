"""autoI guidance and the measurement log-likelihood (PyTorch port of
`kdip_tpu/autoi.py`; ref: condition/condition.py:18-38, 77-81, 133-138).

The reference autodiffs gpytorch's `MultivariateNormal.log_prob` over a
matrix-free covariance. As `kdip_tpu` does, the gradient is taken in
closed form:

    L(x) = log N(y; mu(x), K(x)),   K = sigma_s^2 I + A W diag(v(x)) W^T A^T
    dL/dx = J_mu^T K^{-1} r + J_v^T g_v,          r = y - A mu
    g_v = 0.5 (W^T A^T K^{-1} r)^2 - 0.5 diag(W^T A^T K^{-1} A W)

with K^{-1} by CG (`guidance._cg`) and the diagonal by Hutchinson's
estimate over Rademacher probes z: diag(M) ~ E[z * M z]. One
`torch.autograd.grad` of (x0_mean, v) at x takes both vjps.

Differences of form from `kdip_tpu`, not of result:
- the probes are injected or drawn from a torch.Generator, not from jax's
  fold_in(key, i);
- a host-float variance (above the mle threshold, or an iso covariance)
  makes K's covariance v * u, where `kdip_tpu` runs W^-1(v W u) on a
  constant tensor; the variance then does not depend on x, so it takes no
  cotangent (in `kdip_tpu` its cotangent moves nothing);
- Lanczos is a host loop of device operations (no host read inside it).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import guidance as gd
from .ops.transforms import OrthoTransform, ot_covariance


def rademacher(shape, generator: Optional[torch.Generator] = None,
               device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Independent +-1 entries of `shape`, drawn from `generator`."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=device)
    return (2 * bits - 1).to(dtype)


def measurement_matvec(operator, ortho_tf: OrthoTransform, svar) -> Callable:
    """K(u) = s2 u + A(W diag(v) W^T (A^T u)), the measurement-space
    covariance (ref: condition.py:24-32; `kdip_tpu` autoi.py:134, 176-177),
    for any linear operator and any u: W diag(v) W^T is ot_covariance (for
    "dwt" the fused kernel's no-mask launch), or v * u for a host-float v.
    s2 is float32(max(sigma_s, 1e-3))^2."""
    s2 = gd._sigma_s2(operator, 0.001)
    A, AT = operator.forward, operator.transpose
    cov = (ot_covariance(ortho_tf, svar) if torch.is_tensor(svar)
           else (lambda u: svar * u))

    def K(u):
        return s2 * u + A(cov(AT(u)))
    return K


def _lanczos_tridiag(matvec_flat: Callable, q0: torch.Tensor, k: int):
    """k-step Lanczos of a symmetric operator on flat vectors from the unit
    vector q0 (`kdip_tpu` autoi.py:34-68): (alphas[k], betas[k-1]), the
    diagonal and off-diagonal of the Krylov tridiagonal. Each step
    reorthogonalises against the whole stored (k, d) basis, twice; where
    b <= 1e-8 |a| + 1e-30 (breakdown) the next vector is zero, and so are
    all later ones, which gives zero Ritz pairs of weight 0."""
    d = q0.shape[0]
    Q = q0.new_zeros((k, d))
    Q[0] = q0
    q_prev = torch.zeros_like(q0)
    beta_prev = q0.new_zeros(())
    alphas, betas = [], []
    for i in range(k):
        q = Q[i]
        w = matvec_flat(q) - beta_prev * q_prev
        a = torch.dot(w, q)
        w = w - a * q
        # rows past i are zero, so the whole basis can be used
        w = w - Q.T @ (Q @ w)
        w = w - Q.T @ (Q @ w)
        b = torch.linalg.vector_norm(w)
        q_next = torch.where(b > 1e-8 * a.abs() + 1e-30,
                             w / b.clamp(min=1e-30), torch.zeros_like(w))
        if i + 1 < k:
            Q[i + 1] = q_next
        q_prev, beta_prev = q, b
        alphas.append(a)
        betas.append(b)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def slq_logdet(matvec: Callable, example: torch.Tensor,
               probes: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               num_probes: int = 8, lanczos_iters: int = 25) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of logdet(K) for the symmetric
    positive-definite `matvec` on tensors shaped like `example`
    (`kdip_tpu` autoi.py:71-109):

        logdet(K) ~ (d / m) sum_i sum_j tau_ij^2 log(lambda_ij)

    over m Rademacher probes z_i (|z_i|^2 = d), lambda and tau the
    eigenvalues and first eigenvector components of each probe's
    tridiagonal, the eigenvalues clamped at float32's tiny. `probes` are
    the m probes (any shape of d entries, read in `example`'s order), else
    num_probes are drawn from `generator`. A 0-d tensor."""
    d = example.numel()
    shape = example.shape
    if probes is None:
        probes = [rademacher(shape, generator, example.device, example.dtype)
                  for _ in range(num_probes)]

    def mv_flat(u):
        return matvec(u.reshape(shape)).reshape(-1)

    total = example.new_zeros(())
    scale = torch.tensor(np.sqrt(np.float32(d)), dtype=example.dtype,
                         device=example.device)
    for z in probes:
        q0 = z.reshape(-1).to(example.dtype) / scale
        alphas, betas = _lanczos_tridiag(mv_flat, q0, lanczos_iters)
        T = (torch.diag(alphas) + torch.diag(betas, 1)
             + torch.diag(betas, -1))
        lam, U = torch.linalg.eigh(T)
        # K >= s2 I > 0: a Ritz value at or below zero is breakdown padding
        lam = lam.clamp(min=torch.finfo(lam.dtype).tiny)
        total = total + torch.sum(U[0, :] ** 2 * torch.log(lam))
    return d * total / len(probes)


def measurement_loglikelihood(operator, ortho_tf: OrthoTransform, y, x0_mean,
                              svar, cfg, probes=None,
                              generator: Optional[torch.Generator] = None,
                              lanczos_iters: int = 25):
    """(ll, cg_rel_resid): the scalar log N(y; A x0_mean, K), K =
    measurement_matvec's, the value of the reference's
    `ConditionDenoiser.loglikelihood` (condition.py:77-81;
    `kdip_tpu` autoi.py:112-145). CG solves the quadratic term (its
    relative residual, a host float, is returned), SLQ estimates the
    logdet over cfg.num_probes probes (`probes`, else drawn from
    `generator`). `svar` is the solver-basis variance, a tensor or a host
    float."""
    v = svar.detach() if torch.is_tensor(svar) else svar
    K = measurement_matvec(operator, ortho_tf, v)
    r = y - operator.forward(x0_mean.detach())
    alpha, resid, _ = gd._cg(K, r, cfg)
    quad = torch.dot(r.reshape(-1), alpha.reshape(-1))
    logdet = slq_logdet(K, y, probes, generator, cfg.num_probes,
                        lanczos_iters)
    d = y.numel()
    const = float(np.float32(d) * np.log(np.float32(2 * np.pi)))
    return -0.5 * (quad + logdet + const), resid


def auto_type_I_guidance(uncond_pred: Callable, x0_var_fn: Callable, operator,
                         y: torch.Tensor, cfg, x: torch.Tensor, sigma: float,
                         ortho_tf: OrthoTransform,
                         probes: Sequence[torch.Tensor], v2: bool = False):
    """hat_x0 = x0_mean + sigma^2 d log p(y | x) / dx (ref:
    condition.py:133-138; `kdip_tpu` autoi.py:148-213). Returns (hat_x0,
    the worst |r|/|b| of the K^{-1} solves, their summed iterations): the
    r-solve and one solve per probe in `probes` (Rademacher tensors of x's
    shape). The transforms of the quadratic term and of the probes run as
    `kdip_tpu` runs them: the forward transform once on the r-solve's
    result, and the inverse and the forward once per probe."""
    A, AT = operator.forward, operator.transpose
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        x0_mean, aux = uncond_pred(x, sigma)
        var = x0_var_fn(aux, sigma, None, x.shape)
        x0_var, theta0_var = var if v2 else (var, var)
        svar = x0_var if cfg.ortho_tf_type is None else theta0_var
    tensor_var = torch.is_tensor(svar)
    K = measurement_matvec(operator, ortho_tf,
                           svar.detach() if tensor_var else svar)
    x0m = x0_mean.detach()
    alpha, resid, iters = gd._cg(K, y - A(x0m), cfg)
    # the quadratic term's share of dL/dv: (W^T A^T alpha)^2 / 2
    quad_term = 0.5 * ortho_tf(AT(alpha)) ** 2
    # diag(W^T A^T K^{-1} A W) by Hutchinson's estimate
    diag_est = torch.zeros_like(x0m)
    for z in probes:
        s, res, k = gd._cg(K, A(ortho_tf.inv(z)), cfg)
        diag_est = diag_est + z * ortho_tf(AT(s))
        resid, iters = max(resid, res), iters + k
    g_v = quad_term - 0.5 * (diag_est / len(probes))
    # the mean term's cotangent J_A^T alpha, the vjp of A at x0_mean
    x0d = x0m.detach().requires_grad_(True)
    with torch.enable_grad():
        mean_ct, = torch.autograd.grad(A(x0d), x0d, grad_outputs=alpha)
    outputs, cts = [x0_mean], [mean_ct]
    if tensor_var:
        outputs.append(svar)
        cts.append(g_v.expand(svar.shape))
    score, = torch.autograd.grad(outputs, x, grad_outputs=cts)
    return x0m + gd._f32(np.float32(sigma) ** 2) * score, resid, iters
