"""Discrete-time DDPM sampling loops, VLB terms and classifier-guidance hooks
(PyTorch port of `kdip_tpu/ddpm_sampling.py:29-286`; ref:
guided_diffusion/gaussian_diffusion.py:356-893 and losses.py).

The ancestral (`p_sample_loop`) and DDIM (`ddim_sample_loop`) chains and
`calc_bpd_loop` are Python loops over the (possibly respaced) tables, from
the last index down to 0. `model_fn(x, t)` takes the chain's integer
indices t [B]; a respaced run maps them to the model's timesteps itself
(`diffusion.model_timesteps`). NCHW layout. Every draw is injectable: the
initial x as `noise=`, step i's normal as `noise_fn(i)`; otherwise they
come from `generator` on `device`. `training_losses` takes its q-sample
noise as `noise=`, or draws it from `generator`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from .diffusion import (DiffusionTables, extract, p_mean_variance,
                        predict_eps_from_xstart, predict_xstart_from_eps,
                        q_posterior_mean_variance, q_sample)


# ---------------------------------------------------------------------------
# VLB terms (ref: guided_diffusion/losses.py)
# ---------------------------------------------------------------------------

def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) in nats, elementwise (ref: losses.py:12-39); scalars
    are taken as such."""
    logvar1, logvar2 = (torch.as_tensor(v, dtype=torch.float32)
                        for v in (logvar1, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    """(ref: losses.py:42-47)"""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to the 8-bit bins of
    [-1, 1] (ref: losses.py:50-77)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def _mean_flat(x):
    return x.mean(dim=tuple(range(1, x.ndim)))


# ---------------------------------------------------------------------------
# Classifier guidance hooks (ref: gaussian_diffusion.py:356-393)
# ---------------------------------------------------------------------------

def condition_mean(tables: DiffusionTables, cond_fn: Callable,
                   p_mean_var: Dict, x, t):
    """The reverse mean shifted by variance * grad log p(y|x)
    (ref: gaussian_diffusion.py:356-369); cond_fn(x, t) gives the grad."""
    return p_mean_var["mean"] + p_mean_var["variance"] * cond_fn(x, t)


def condition_score(tables: DiffusionTables, cond_fn: Callable,
                    p_mean_var: Dict, x, t):
    """Score-based conditioning of Song et al.
    (ref: gaussian_diffusion.py:371-393)."""
    alpha_bar = extract(tables.alphas_cumprod, t, x.ndim)
    eps = predict_eps_from_xstart(tables, x, t, p_mean_var["pred_xstart"])
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, t)
    out = dict(p_mean_var)
    out["pred_xstart"] = predict_xstart_from_eps(tables, x, t, eps)
    out["mean"], _, _ = q_posterior_mean_variance(tables, out["pred_xstart"],
                                                  x, t)
    return out


# ---------------------------------------------------------------------------
# Ancestral and DDIM chains (ref: gaussian_diffusion.py:395-682)
# ---------------------------------------------------------------------------

def _nonzero_mask(t, x):
    return (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


def _normal(x, noise, generator):
    return noise if noise is not None else torch.randn(
        x.shape, generator=generator, device=x.device, dtype=x.dtype)


def p_sample(tables: DiffusionTables, model_fn: Callable, x, t,
             noise=None, generator: Optional[torch.Generator] = None,
             clip_denoised: bool = True, cond_fn: Optional[Callable] = None,
             learn_sigma: bool = True, predict_xstart: bool = False,
             sigma_small: bool = False):
    """One ancestral reverse step at indices t [B] with the given normal
    `noise` (else drawn from `generator`) (ref: gaussian_diffusion.py:
    395-439). Returns (sample, pred_xstart)."""
    out = p_mean_variance(tables, model_fn(x, t), x, t, clip_denoised,
                          learn_sigma, predict_xstart=predict_xstart,
                          sigma_small=sigma_small)
    if cond_fn is not None:
        out["mean"] = condition_mean(tables, cond_fn, out, x, t)
    noise = _normal(x, noise, generator)
    sample = (out["mean"] + _nonzero_mask(t, x)
              * torch.exp(0.5 * out["log_variance"]) * noise)
    return sample, out["pred_xstart"]


def ddim_sample(tables: DiffusionTables, model_fn: Callable, x, t,
                noise=None, generator: Optional[torch.Generator] = None,
                eta: float = 0.0, clip_denoised: bool = True,
                cond_fn: Optional[Callable] = None, learn_sigma: bool = True,
                predict_xstart: bool = False, sigma_small: bool = False):
    """One DDIM step (ref: gaussian_diffusion.py:497-546). Returns
    (sample, pred_xstart)."""
    out = p_mean_variance(tables, model_fn(x, t), x, t, clip_denoised,
                          learn_sigma, predict_xstart=predict_xstart,
                          sigma_small=sigma_small)
    if cond_fn is not None:
        out = condition_score(tables, cond_fn, out, x, t)
    nd = x.ndim
    eps = predict_eps_from_xstart(tables, x, t, out["pred_xstart"])
    alpha_bar = extract(tables.alphas_cumprod, t, nd)
    alpha_bar_prev = extract(tables.alphas_cumprod_prev, t, nd)
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    noise = _normal(x, noise, generator)
    mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
    return mean_pred + _nonzero_mask(t, x) * sigma * noise, out["pred_xstart"]


def _chain(step: Callable, tables: DiffusionTables, shape, generator, noise,
           noise_fn, device):
    """x_T from `noise` (else drawn), then `step(x, t, noise)` at each index
    from T - 1 down to 0, step i's normal from noise_fn(i) (else drawn)."""
    x = noise if noise is not None else torch.randn(
        shape, generator=generator, device=device)
    for i, t_rev in enumerate(range(tables.num_timesteps - 1, -1, -1)):
        t = torch.full((x.shape[0],), t_rev, dtype=torch.int64,
                       device=x.device)
        x, _ = step(x, t, _normal(x, None if noise_fn is None
                                  else noise_fn(i), generator))
    return x


def p_sample_loop(tables: DiffusionTables, model_fn: Callable, shape,
                  generator: Optional[torch.Generator] = None,
                  clip_denoised: bool = True,
                  cond_fn: Optional[Callable] = None, noise=None,
                  learn_sigma: bool = True, predict_xstart: bool = False,
                  sigma_small: bool = False,
                  noise_fn: Optional[Callable] = None, device="cuda"):
    """The whole ancestral chain (ref: gaussian_diffusion.py:441-495)."""
    return _chain(lambda x, t, z: p_sample(
        tables, model_fn, x, t, z, None, clip_denoised, cond_fn, learn_sigma,
        predict_xstart, sigma_small), tables, shape, generator, noise,
        noise_fn, device)


def ddim_sample_loop(tables: DiffusionTables, model_fn: Callable, shape,
                     generator: Optional[torch.Generator] = None,
                     eta: float = 0.0, clip_denoised: bool = True,
                     cond_fn: Optional[Callable] = None, noise=None,
                     learn_sigma: bool = True, predict_xstart: bool = False,
                     sigma_small: bool = False,
                     noise_fn: Optional[Callable] = None, device="cuda"):
    """The whole DDIM chain (ref: gaussian_diffusion.py:625-682)."""
    return _chain(lambda x, t, z: ddim_sample(
        tables, model_fn, x, t, z, None, eta, clip_denoised, cond_fn,
        learn_sigma, predict_xstart, sigma_small), tables, shape, generator,
        noise, noise_fn, device)


# ---------------------------------------------------------------------------
# Bits per dim (ref: gaussian_diffusion.py:696-742, 818-893)
# ---------------------------------------------------------------------------

def vb_terms_bpd(tables: DiffusionTables, model_fn: Callable, x_start, x_t, t,
                 clip_denoised: bool = True, learn_sigma: bool = True,
                 frozen_mean: bool = False, predict_xstart: bool = False,
                 sigma_small: bool = False):
    """The variational bound's term at indices t, in bits per dim
    (ref: gaussian_diffusion.py:696-742): the decoder NLL at t = 0, the KL
    elsewhere. `frozen_mean` detaches the mean head (RESCALED_MSE's VB
    term, :771-780)."""
    true_mean, _, true_log_var = q_posterior_mean_variance(tables, x_start,
                                                           x_t, t)
    model_output = model_fn(x_t, t)
    if frozen_mean and learn_sigma:
        C = x_t.shape[1]
        model_output = torch.cat([model_output[:, :C].detach(),
                                  model_output[:, C:]], dim=1)
    out = p_mean_variance(tables, model_output, x_t, t, clip_denoised,
                          learn_sigma, predict_xstart=predict_xstart,
                          sigma_small=sigma_small)
    kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
    kl = _mean_flat(kl) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
    decoder_nll = _mean_flat(decoder_nll) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl),
            "pred_xstart": out["pred_xstart"]}


def training_losses(tables: DiffusionTables, model_fn: Callable, x_start, t,
                    generator: Optional[torch.Generator] = None,
                    loss_type: str = "mse", learn_sigma: bool = True,
                    noise=None, predict_xstart: bool = False,
                    sigma_small: bool = False) -> Dict[str, torch.Tensor]:
    """The per-example training loss terms, each [B]
    (ref: gaussian_diffusion.py:744-835; `kdip_tpu` ddpm_sampling.py:
    211-249). loss_type is mse, rescaled_mse, kl or rescaled_kl. Under the
    MSE types with `learn_sigma`, "vb" is the VB term with the mean head
    detached (times T/1000 under rescaled_mse), and "loss" = "mse" +
    "vb". With `predict_xstart` the MSE target is x_start, else the
    noise. The noise is `noise=`, else a normal draw from `generator`."""
    noise = _normal(x_start, noise, generator)
    x_t = q_sample(tables, x_start, t, noise)
    terms = {}
    T = tables.num_timesteps
    if loss_type in ("kl", "rescaled_kl"):
        terms["loss"] = vb_terms_bpd(tables, model_fn, x_start, x_t, t,
                                     clip_denoised=False,
                                     learn_sigma=learn_sigma,
                                     predict_xstart=predict_xstart,
                                     sigma_small=sigma_small)["output"]
        if loss_type == "rescaled_kl":
            terms["loss"] = terms["loss"] * T
        return terms
    if loss_type not in ("mse", "rescaled_mse"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    model_output = model_fn(x_t, t)
    C = x_start.shape[1]
    if learn_sigma:
        terms["vb"] = vb_terms_bpd(tables, lambda *_: model_output, x_start,
                                   x_t, t, clip_denoised=False,
                                   learn_sigma=True, frozen_mean=True,
                                   predict_xstart=predict_xstart,
                                   sigma_small=sigma_small)["output"]
        if loss_type == "rescaled_mse":
            terms["vb"] = terms["vb"] * T / 1000.0
        mean_pred = model_output[:, :C]
    else:
        mean_pred = model_output
    target = x_start if predict_xstart else noise
    terms["mse"] = _mean_flat((target - mean_pred) ** 2)
    terms["loss"] = terms["mse"] + terms.get("vb", 0.0)
    return terms


def prior_bpd(tables: DiffusionTables, x_start):
    """KL(q(x_T | x_0) || N(0, I)) in bits per dim
    (ref: gaussian_diffusion.py:818-835)."""
    t = torch.full((x_start.shape[0],), tables.num_timesteps - 1,
                   dtype=torch.int64, device=x_start.device)
    nd = x_start.ndim
    qt_mean = extract(tables.sqrt_alphas_cumprod, t, nd) * x_start
    qt_log_var = torch.log(1.0 - extract(tables.alphas_cumprod, t, nd))
    kl_prior = normal_kl(qt_mean, qt_log_var, 0.0, 0.0)
    return _mean_flat(kl_prior) / math.log(2.0)


def calc_bpd_loop(tables: DiffusionTables, model_fn: Callable, x_start,
                  generator: Optional[torch.Generator] = None,
                  clip_denoised: bool = True, learn_sigma: bool = True,
                  noise_fn: Optional[Callable] = None):
    """The whole variational bound over every index, T - 1 down to 0, step
    i's q-sample noise from noise_fn(i) (else drawn) (ref:
    gaussian_diffusion.py:837-893). vb, xstart_mse and mse are [B, T] in
    that order."""
    vb, xstart_mse, mse = [], [], []
    for i, t_rev in enumerate(range(tables.num_timesteps - 1, -1, -1)):
        t = torch.full((x_start.shape[0],), t_rev, dtype=torch.int64,
                       device=x_start.device)
        noise = _normal(x_start, None if noise_fn is None else noise_fn(i),
                        generator)
        x_t = q_sample(tables, x_start, t, noise)
        out = vb_terms_bpd(tables, model_fn, x_start, x_t, t, clip_denoised,
                           learn_sigma)
        eps = predict_eps_from_xstart(tables, x_t, t, out["pred_xstart"])
        vb.append(out["output"])
        xstart_mse.append(_mean_flat((out["pred_xstart"] - x_start) ** 2))
        mse.append(_mean_flat((eps - noise) ** 2))
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
    prior = prior_bpd(tables, x_start)
    return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior,
            "vb": vb, "xstart_mse": xstart_mse, "mse": mse}
