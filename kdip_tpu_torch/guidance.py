"""Conditional denoising E[x0 | xt, y] (PyTorch port of `kdip_tpu/guidance.py`;
ref: condition/condition.py).

Ported: every guidance mode of `kdip_tpu` (uncond, I, II, dps, pgdm,
diffpir, stsl, autoI and dps+mle / pgdm+mle / stsl+mle) for the OpenAI ADM
models, with the Convert, tmpd, analytic, pgdm, dps and diffpir covariances
(V1) and the learned DWT/DCT/spatial covariance heads (V2) of the ADM
and the k-diffusion native models (`make_kdiff_v2_uncond`); the likelihood
solves of the four linear operators: inpainting, deblurring (gaussian,
motion), bicubic super-resolution and colorization, with the CG warm start
(cg_warm_start); and `denoise.loglikelihood`, the measurement
log-likelihood's value (`autoi.measurement_loglikelihood`).

Differences of form from `kdip_tpu`, not of result:
- sigma is a host-side float, so the mle-threshold switches
  (`lax.cond(sigma < mle_sigma_thres)`, guidance.py:637, 821) are Python
  `if`s, and the closed-form branch never computes the covariance tensors;
- the CG loop runs on the host, testing its stopping rule after every
  iteration, which reads the residual back from the device; a solve that
  ends above tolerance warns (cg_warn) from the same read. Each such
  blocking read counts in `host_read_counts` and is a
  `profiling.span("guidance.host_read")`, inside the spans of the guided
  call (`guidance.nfe`), its UNet forward, vjp and solve;
- the likelihood score is `torch.autograd.grad` of x0_mean at x, and
  tmpd's variance a first `autograd.grad` on the retained graph; where no
  vjp is needed (Type-II but with tmpd, diffpir, uncond) the UNet runs
  under `torch.no_grad()`;
- Type-II's step W^-1(W mat * svar) with a scalar svar is mat * svar
  (the orthonormal transform cancels);
- stsl's Hutchinson probes and autoI's Rademacher probes are injected
  (`probes=`) or drawn from a torch.Generator, not from jax's
  fold_in(key, i);
- the warm start's solver state is a dict of tensors, and the per-sample
  loop keeps a list of n such states (`kdip_tpu` stacks them);
- under `batch_group(group)` (the sharded sampler of
  `parallel.sharding`) the batch is split over the group's ranks, and
  every reduction over it sums across them (the CG's inner products, the
  iso covariances' means, dps's and stsl's norms and sums), where
  `kdip_tpu`'s reductions run over one global array.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as tdist
import torch.utils.checkpoint as tcp

from . import diffusion as diff
from . import precond
from .operators import (BlurOperator, ColorizationOperator,
                        InpaintingOperator, Measurement,
                        SuperResolutionOperator)
from .ops import fft as offt
from .ops.transforms import OrthoTransform, ot_covariance
from .parallel import dist as pdist
from .profiling import span

# How each covariance reaches the solve (ref: kdip_tpu guidance.py:585-589,
# the reference's theta0_var.numel() == 1 dispatch): "switch" - CG with the
# covariance below mle_sigma_thres, the closed form at mle_var above (Convert
# and the V2 heads); "tensor" - CG at every sigma (tmpd); "iso" - always the
# closed form at a scalar variance (pgdm, dps, diffpir, and analytic's
# per-sigma table entry).
_COV_KIND = {"convert": "switch", "tmpd": "tensor", "pgdm": "iso",
             "dps": "iso", "diffpir": "iso", "analytic": "iso"}
GUIDANCE_MODES = ("uncond", "I", "II", "dps", "pgdm", "diffpir", "stsl",
                  "autoI")
MLE_MODES = ("dps+mle", "pgdm+mle", "stsl+mle")


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Guidance configuration (ref: condition.py:44-71; the fields of
    `kdip_tpu.guidance.GuidanceConfig` that the port uses). cg_maxiter
    None is the reference's 1000-iteration budget; CG stops once
    |r|^2 <= cg_tol^2 |b|^2. cg_precondition preconditions CG with the
    closed-form isotropic solve at the mean variance: fewer iterations on
    near-isotropic covariances, harmful on wide-range ones such as tmpd's
    (kdip_tpu guidance.py:65-74); off, as in the reference's scipy CG.
    cg_warn warns (RuntimeWarning) when a solve exits above tolerance, as
    the reference's scipy CG does (condition.py:344-345). cg_warm_start
    seeds each solve of guidance I/II with the previous sampler step's CG
    iterate (`kdip_tpu` guidance.py:82-92; off, as the reference's scipy
    CG always starts from zero). zeta (dps, stsl), lambda_ (diffpir), eta
    and num_hutchinson_samples (stsl) are the modes' step sizes and probe
    count; num_probes is autoI's Hutchinson probe count and SLQ's.
    remat_vjp runs the denoiser's forward again in the backward of the
    guidance vjp (`kdip_tpu` guidance.py:96-131; the same numbers, one more
    forward): True under `torch.utils.checkpoint`, "conv_dots" keeping
    only the conv and matmul outputs (see `remat_pred`); off by default.
    One region holds the whole UNet call, so the backward rebuilds all of
    its activations at once: on the H100 neither setting lowered the peak
    memory, and both were slower (PERF.md §6)."""
    guidance: str = "I"
    x0_cov_type: str = "convert"
    mle_sigma_thres: float = 0.2
    zeta: Optional[float] = None
    lambda_: Optional[float] = None
    eta: Optional[float] = None
    num_hutchinson_samples: Optional[int] = None
    ortho_tf_type: Optional[str] = None
    cg_tol: float = 1e-4
    cg_maxiter: Optional[int] = None
    cg_precondition: bool = False
    cg_warn: bool = True
    cg_warm_start: bool = False
    num_probes: int = 8
    remat_vjp: Any = False

    def __post_init__(self):
        if not any(self.remat_vjp is v for v in (False, True)) \
                and self.remat_vjp != "conv_dots":
            # jax's other checkpoint_policies names have no torch counterpart
            raise ValueError(f"remat_vjp takes False, True or 'conv_dots', "
                             f"got {self.remat_vjp!r}")


def resolved_cg_maxiter(cfg: GuidanceConfig) -> int:
    return 1000 if cfg.cg_maxiter is None else cfg.cg_maxiter


def _f32(v) -> float:
    """A host scalar rounded to float32, as `kdip_tpu` computes its scalars."""
    return float(np.float32(v))


# The ops whose outputs remat_vjp="conv_dots" keeps: convolutions and
# matrix products (`kdip_tpu`'s conv_general_dilated and dot_general).
_CONV_DOTS = ("convolution", "mm", "bmm", "addmm", "baddbmm",
              "_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_cudnn_attention",
              "_scaled_dot_product_flash_attention_for_cpu")


def _conv_dots_policy(ctx, op, *args, **kwargs):
    name = op.overloadpacket.__name__
    return (tcp.CheckpointPolicy.MUST_SAVE if name in _CONV_DOTS
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_pred(uncond_pred: Callable, spec) -> Callable:
    """uncond_pred(x, sigma) under GuidanceConfig.remat_vjp's recompute:
    itself for False; for True the whole call under a non-reentrant
    `torch.utils.checkpoint`, which the backward runs again; for
    "conv_dots" a selective checkpoint that keeps the outputs of the aten
    convolutions and matrix products and recomputes the rest. The
    Winograd kernels (ops.winograd) launch from autograd Functions through
    ctypes, which no aten op covers, so "conv_dots" recomputes their
    outputs as True does: a backward launches each Winograd forward kernel
    once more, as under `kdip_tpu`, whose policy sees a pallas_call and
    not a conv_general_dilated.

    The region is the whole UNet call, so its backward rebuilds every
    activation of the region before it backpropagates through them: the
    peak memory is no-remat's at any batch size. On the H100 (FFHQ
    Winograd torso, B=1) neither setting saved time or memory: both were
    slower than no remat in every run, "conv_dots" 2.1-2.4x, and the peak
    did not move (PERF.md §5-6)."""
    if spec is False:
        return uncond_pred
    kw = {} if spec is True else dict(context_fn=functools.partial(
        tcp.create_selective_checkpoint_contexts, _conv_dots_policy))

    def pred(x, sigma):
        return tcp.checkpoint(uncond_pred, x, sigma, use_reentrant=False,
                              **kw)
    return pred


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

def _host_f32(a) -> np.ndarray:
    """A table (numpy, list or tensor on any device) as float32 numpy."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
    return np.asarray(a, np.float32)


def make_openai_uncond(model_apply: Callable, tables: diff.DiffusionTables,
                       cfg: GuidanceConfig,
                       recon_mse: Optional[Dict[str, object]] = None):
    """uncond_pred of ConditionOpenAIDenoiser (ref: condition.py:231-274).

    model_apply(x_scaled, t_int) -> the raw ADMUNet output (eps + variance
    values, 2C channels). Returns (uncond_pred, x0_var_fn):
    uncond_pred(x, sigma) -> (x0_mean, aux); x0_var_fn(aux, sigma,
    mean_vjp, x_shape) -> for "convert" the Eq.22 covariance below
    mle_sigma_thres, mle_var(sigma) above; for "tmpd" sigma^2 times the
    vjp of x0_mean with a ones cotangent (ref: condition.py:268-269),
    `mean_vjp(ct)` being the caller's vjp of x0_mean at x; for the iso
    covariances a host float: "pgdm" mle_var(sigma), "dps" 0, "diffpir"
    sigma^2 / lambda_, "analytic" below mle_sigma_thres the
    recon_mse["mse_list"] entry at the nearest recon_mse["sigmas"], above
    it mle_var(sigma) (`kdip_tpu` guidance.py:168-191)."""
    cov = cfg.x0_cov_type
    if cov not in _COV_KIND:
        raise ValueError(f"unrecognized posterior covariance type {cov!r}")
    if cov == "analytic":
        if recon_mse is None:
            raise ValueError("the analytic covariance needs recon_mse")
        mse_sigmas = _host_f32(recon_mse["sigmas"])
        mse_list = _host_f32(recon_mse["mse_list"])
    if cov == "diffpir" and cfg.lambda_ is None:
        raise ValueError("the diffpir covariance needs lambda_")
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

    def x0_var_fn(aux, sigma, mean_vjp=None, x_shape=None):
        if cov == "tmpd":
            ones = torch.ones(x_shape, device=aux["t"].device)
            return mean_vjp(ones) * _f32(np.float32(sigma) ** 2)
        if cov == "pgdm":
            return mle_var(sigma)
        if cov == "dps":
            return 0.0
        if cov == "diffpir":
            return _f32(np.float32(sigma) ** 2 / np.float32(cfg.lambda_))
        if sigma >= cfg.mle_sigma_thres:
            return mle_var(sigma)
        if cov == "analytic":
            idx = np.argmin(np.abs(mse_sigmas - np.float32(sigma)))
            return float(mse_list[idx])
        return diff.convert_x0_var(tables, aux["variance"], aux["t"])

    return uncond_pred, x0_var_fn


def make_openai_v2_uncond(model_apply: Callable, tables: diff.DiffusionTables,
                          cfg: GuidanceConfig):
    """uncond_pred of ConditionOpenAIDenoiserV2 (ref: condition.py:287-300).

    model_apply(x_scaled, t) -> (eps, logvar, logvar_ot), the ADMUNetV2
    forward. x0_var_fn(aux, sigma, ...) -> (x0_var, theta0_var): the
    learned variances below mle_sigma_thres, mle_var(sigma) above (the
    vjp arguments of make_openai_uncond's are unused here)."""
    log_sigmas = tables.log_sigmas.cpu()

    def uncond_pred(x, sigma):
        c_out, c_in = precond.eps_scalings(np.float32(sigma))
        t = _model_t(log_sigmas, sigma).to(x.device)
        eps, logvar, logvar_ot = model_apply(x * _f32(c_in),
                                             t.expand(x.shape[0]))
        x0_mean = eps * _f32(c_out) + x
        return x0_mean, {"logvar": logvar, "logvar_ot": logvar_ot}

    def x0_var_fn(aux, sigma, mean_vjp=None, x_shape=None):
        if sigma < cfg.mle_sigma_thres:
            c_out2 = _f32(np.float32(sigma) ** 2)
            return (torch.exp(aux["logvar"]).to(torch.float32) * c_out2,
                    torch.exp(aux["logvar_ot"]).to(torch.float32) * c_out2)
        return mle_var(sigma), mle_var(sigma)

    return uncond_pred, x0_var_fn


def make_kdiff_v2_uncond(model_apply: Callable, cfg: GuidanceConfig,
                         sigma_data: float = 0.5):
    """uncond_pred of the k-diffusion native variance model
    (ImageDenoiserModelV2, `"type": "image_v2"`; `kdip_tpu`
    guidance.py:225-260): the V2 learned-covariance treatment with EDM
    c_skip/c_out/c_in preconditioning (`precond.edm_scalings` at
    `sigma_data`, float32 host scalars).

    model_apply(x_scaled, sigma_b) -> (out, logvar, logvar_ot), the model
    with return_variance=True; sigma_b is [B]. x0_var_fn(aux, sigma, ...)
    -> (x0_var, theta0_var): exp(logvar) c_out^2 and exp(logvar_ot)
    c_out^2 below mle_sigma_thres, mle_var(sigma) above."""
    sd = np.float32(sigma_data)

    def scalings(sigma):
        return [_f32(c) for c in precond.edm_scalings(np.float32(sigma), sd)]

    def uncond_pred(x, sigma):
        c_skip, c_out, c_in = scalings(sigma)
        sigma_b = torch.full((x.shape[0],), _f32(sigma), device=x.device)
        out, logvar, logvar_ot = model_apply(x * c_in, sigma_b)
        x0_mean = out * c_out + x * c_skip
        return x0_mean, {"logvar": logvar, "logvar_ot": logvar_ot}

    def x0_var_fn(aux, sigma, mean_vjp=None, x_shape=None):
        if sigma < cfg.mle_sigma_thres:
            c_out2 = _f32(np.float32(scalings(sigma)[1]) ** 2)
            return (torch.exp(aux["logvar"]).to(torch.float32) * c_out2,
                    torch.exp(aux["logvar_ot"]).to(torch.float32) * c_out2)
        return mle_var(sigma), mle_var(sigma)

    return uncond_pred, x0_var_fn


# ---------------------------------------------------------------------------
# Reductions over the batch, across the ranks of a sharded batch
# ---------------------------------------------------------------------------

_BATCH_GROUP = None

# the solves' blocking device-to-host reads since the last
# reset_host_read_counts(), by site: the CG's stopping test each iteration,
# its exit residual, the iso solve's mean variance
host_read_counts = {"cg_residual": 0, "cg_exit": 0, "iso_mean": 0}


def reset_host_read_counts() -> None:
    for k in host_read_counts:
        host_read_counts[k] = 0


@contextlib.contextmanager
def batch_group(group):
    """Within the block, the batch is this rank's block of a batch split
    over `group` (a torch.distributed process group; None: no split), and
    the reductions below sum over the whole batch."""
    global _BATCH_GROUP
    previous, _BATCH_GROUP = _BATCH_GROUP, group
    try:
        yield
    finally:
        _BATCH_GROUP = previous


class _AllSum(torch.autograd.Function):
    """The sum of a partial sum over the group's ranks. Every rank holds
    the same total downstream, so the gradient of a rank's partial is the
    total's own: the backward passes it through."""

    @staticmethod
    def forward(ctx, t):
        out = pdist.all_reduce(t.detach().reshape(1).clone(), _BATCH_GROUP)
        return out.reshape(t.shape)

    @staticmethod
    def backward(ctx, grad):
        return grad


def _batch_sum(partial: torch.Tensor) -> torch.Tensor:
    """A 0-dim sum over this rank's batch, summed over the batch group."""
    return partial if _BATCH_GROUP is None else _AllSum.apply(partial)


def _batch_numel(t: torch.Tensor) -> int:
    if _BATCH_GROUP is None:
        return t.numel()
    return t.numel() * tdist.get_world_size(_BATCH_GROUP)


def _batch_mean(t: torch.Tensor) -> torch.Tensor:
    if _BATCH_GROUP is None:
        return t.mean()
    return _batch_sum(t.sum()) / _batch_numel(t)


def _batch_norm(t: torch.Tensor) -> torch.Tensor:
    if _BATCH_GROUP is None:
        return torch.linalg.vector_norm(t)
    return torch.sqrt(_batch_sum(t.square().sum()))


# ---------------------------------------------------------------------------
# Likelihood solves: v = (sigma_s^2 I + A Sigma A^T)^{-1} (y - A x0_mean)
# ---------------------------------------------------------------------------

def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _batch_sum(torch.dot(a.reshape(-1), b.reshape(-1)))


def _above(rs: torch.Tensor, atol2: torch.Tensor) -> bool:
    """The CG's stopping test rs > atol2, read on the host."""
    host_read_counts["cg_residual"] += 1
    with span("guidance.host_read"):
        return bool(rs > atol2)


def _cg_with_residual(matvec, b: torch.Tensor, tol: float, maxiter: int,
                      M=None, x0: Optional[torch.Tensor] = None):
    """Conjugate gradients from x0 (default 0) in the update order of
    jax.scipy.sparse.linalg.cg (`kdip_tpu` guidance.py:268-311), stopping
    once rs = |r|^2 <= tol^2 |b|^2 or after maxiter iterations; the first
    residual is b - A x0, and the stopping rule does not change with x0
    (scipy's x0 semantics). With a preconditioner M, z = M(r) and gamma =
    <r, z>, and rs is <r, r> (one more reduction an iteration). The test
    reads rs on the host after every iteration. Returns (x, rs, atol2,
    iterations), rs and atol2 as 0-d device tensors."""
    preconditioned = M is not None
    M = M if preconditioned else (lambda v: v)
    bs = _vdot(b, b)
    atol2 = torch.tensor(tol, dtype=b.dtype, device=b.device).square() * bs
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    r = b - matvec(x)
    p = z = M(r)
    gamma = _vdot(r, z)
    rs = _vdot(r, r) if preconditioned else gamma
    k = 0
    while k < maxiter and _above(rs, atol2):
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_ = _vdot(r, z)
        p = z + (gamma_ / gamma) * p
        gamma = gamma_
        rs = _vdot(r, r) if preconditioned else gamma
        k += 1
    return x, rs, atol2, k


def _cg(matvec, b, cfg: GuidanceConfig, M=None, x0=None):
    """CG returning (x, rel_resid, iterations) with rel_resid = |r|/|b| at
    exit as a host float (0 for b == 0) (`kdip_tpu` guidance.py:327-352).
    M preconditions only with cfg.cg_precondition; x0 warm-starts the
    solve. With cfg.cg_warn a solve that exits above tolerance warns with
    `kdip_tpu`'s message; the test rides on the one host read of the
    residual."""
    maxiter = resolved_cg_maxiter(cfg)
    x, rs, atol2, k = _cg_with_residual(matvec, b, cfg.cg_tol, maxiter,
                                        M if cfg.cg_precondition else None,
                                        x0)
    bs = atol2 / torch.tensor(cfg.cg_tol, dtype=rs.dtype).square()
    rel = torch.sqrt(rs / bs.clamp(min=torch.finfo(rs.dtype).tiny))
    host_read_counts["cg_exit"] += 1
    with span("guidance.host_read"):
        rel, above = torch.stack([rel, (rs > atol2).to(rel.dtype)]).tolist()
    if cfg.cg_warn and above:
        warnings.warn(f"CG did not converge in {maxiter} iters: "
                      f"|r|/|b| = {np.float32(rel)}", RuntimeWarning,
                      stacklevel=2)
    return x, rel, k


def _closed(mat, u0, want_state):
    """A closed-form solver's return: no CG ran, so the residual is 0, and
    with want_state the warm-start state u0 passes through (`kdip_tpu`
    guidance.py:363-370)."""
    if want_state:
        return mat, 0.0, 0, {"u": u0, "iters": 0}
    return mat, 0.0, 0


def _via_cg(matvec, b, cfg, M, u0, want_state, post=lambda u: u):
    """A CG solver's return: (post(u), rel_resid, iterations), and with
    want_state {"u": u, "iters": iterations}, u being the raw CG variable
    (the next step's warm start) (`kdip_tpu` guidance.py:373-382)."""
    u, resid, iters = _cg(matvec, b, cfg, M, x0=u0)
    if want_state:
        return post(u), resid, iters, {"u": u, "iters": iters}
    return post(u), resid, iters


def _sigma_s2(op, floor: float) -> float:
    """float32(max(sigma_s, floor))^2, the reference's clipped noise
    variance."""
    return _f32(max(np.float32(op.sigma_s), np.float32(floor)) ** 2)


def _iso_denom(s2: float, theta, scale=1.0) -> float:
    """float32(s2 + float32(theta / scale)), as kdip_tpu's scalars round."""
    return _f32(np.float32(s2) + np.float32(theta) / np.float32(scale))


def inpainting_mat(op: InpaintingOperator, y, x0_mean, theta0_var, ortho_tf,
                   iso: bool, cfg: GuidanceConfig, *, u0=None,
                   want_state=False):
    """(ref: condition.py:317-348) Returns (mat, rel_resid, cg_iterations),
    and with want_state the warm-start state (see mat_solver)."""
    mask = op.mask
    sigma_s2 = _sigma_s2(op, 0.001)
    b = mask * y - mask * x0_mean
    if iso:
        return _closed(b / _iso_denom(sigma_s2, theta0_var), u0, want_state)

    def matvec(v):  # sigma_s2 v + mask W^-1(theta0_var W v), fused
        return ortho_tf.masked_cov_matvec(v, theta0_var, mask, sigma_s2)

    # the closed-form isotropic solve at the mean variance
    theta_bar = _batch_mean(theta0_var)

    def iso_inverse(v):
        return v / (sigma_s2 + mask * theta_bar)

    return _via_cg(matvec, b, cfg, iso_inverse, u0, want_state)


def deblur_mat(op: BlurOperator, y, x0_mean, theta0_var, ortho_tf,
               iso: bool, cfg: GuidanceConfig, *, u0=None, want_state=False):
    """(ref: condition.py:351-398) The FFT closed form, or CG on
    (s2 I + A C A^T) u = y - A x0_mean, returning A^T u."""
    s2 = _sigma_s2(op, 0.001)
    FB, FBC, F2B = op.FB, op.FBC, op.F2B
    if iso:
        num = offt.fft2(y - offt.ifft2(FB * offt.fft2(x0_mean)).real)
        mat = offt.ifft2(num / (s2 + theta0_var * F2B) * FBC).real
        return _closed(mat, u0, want_state)
    cov = ot_covariance(ortho_tf, theta0_var)
    b = y - offt.ifft2(FB * offt.fft2(x0_mean)).real

    def matvec(u):
        Cu = cov(offt.ifft2(FBC * offt.fft2(u)).real)
        return s2 * u + offt.ifft2(FB * offt.fft2(Cu)).real

    # the exact FFT inverse of the isotropic system at the mean variance
    theta_bar = _batch_mean(theta0_var)

    def iso_inverse(u):
        return offt.ifft2(offt.fft2(u) / (s2 + theta_bar * F2B)).real

    return _via_cg(matvec, b, cfg, iso_inverse, u0, want_state,
                   lambda u: offt.ifft2(FBC * offt.fft2(u)).real)


def _block_mean_f2b(F2B: torch.Tensor, sf: int) -> torch.Tensor:
    """invW: the mean of |FB|^2 over the sf x sf aliasing blocks, [h, w]
    (ref: condition.py:409 via sr.splits; kdip_tpu guidance.py:460-463)."""
    H, W = F2B.shape[-2:]
    return F2B.reshape(sf, H // sf, sf, W // sf).permute(1, 3, 0, 2).reshape(
        H // sf, W // sf, sf * sf).mean(dim=-1)


def super_resolution_mat(op: SuperResolutionOperator, y, x0_mean, theta0_var,
                         ortho_tf, iso: bool, cfg: GuidanceConfig, *,
                         u0=None, want_state=False):
    """(ref: condition.py:401-439) Solves with the FFT form of A (blur, then
    every sf-th pixel), not the bicubic forward, as the reference does;
    sigma_s is clipped at 1e-2 here. The CG variable is low-resolution."""
    s2 = _sigma_s2(op, 1e-2)
    sf = op.scale_factor
    FB, FBC = op.FB, op.FBC
    invW = _block_mean_f2b(op.F2B, sf)

    def A_fft(x):
        return offt.downsample(offt.ifft2(FB * offt.fft2(x)), sf).real

    def AT_fft(u):
        return offt.ifft2(FBC * offt.fft2(offt.upsample(u, sf))).real

    if iso:
        num = offt.fft2(y - A_fft(x0_mean))
        ratio = num / (s2 + theta0_var * invW)
        mat = offt.ifft2(FBC * ratio.repeat(1, 1, sf, sf)).real
        return _closed(mat, u0, want_state)
    cov = ot_covariance(ortho_tf, theta0_var)
    b = y - A_fft(x0_mean)

    def matvec(u):
        return s2 * u + A_fft(cov(AT_fft(u)))

    # the exact low-resolution Fourier inverse of the isotropic system
    theta_bar = _batch_mean(theta0_var)

    def iso_inverse(u):
        return offt.ifft2(offt.fft2(u) / (s2 + theta_bar * invW)).real

    return _via_cg(matvec, b, cfg, iso_inverse, u0, want_state, AT_fft)


def colorization_mat(op: ColorizationOperator, y, x0_mean, theta0_var,
                     ortho_tf, iso: bool, cfg: GuidanceConfig, *, u0=None,
                     want_state=False):
    """A = the channel mean, so A A^T = I/3 (kdip_tpu guidance.py:496-516;
    the reference registers no solver for it): the closed form, or CG in
    y-space (one channel); returns A^T u."""
    s2 = _sigma_s2(op, 0.001)
    b = y - op.forward(x0_mean)
    if iso:
        return _closed(op.transpose(b / _iso_denom(s2, theta0_var, 3.0)),
                       u0, want_state)
    cov = ot_covariance(ortho_tf, theta0_var)

    def matvec(u):
        return s2 * u + cov(op.transpose(u)).mean(dim=1, keepdim=True)

    theta_bar = _batch_mean(theta0_var)

    def iso_inverse(u):
        return u / (s2 + theta_bar / 3.0)

    return _via_cg(matvec, b, cfg, iso_inverse, u0, want_state, op.transpose)


def mat_solver(op, y, x0_mean, theta0_var, ortho_tf, iso: bool,
               cfg: GuidanceConfig, *, u0=None, want_state=False):
    """Registry dispatch on the operator (ref: condition.py:307-314). Each
    solver returns (mat, rel_resid, cg_iterations); with want_state it
    appends {"u": the raw CG variable, "iters": cg_iterations}, the warm
    start of the next solve (u0 passes through a closed form); u0 seeds
    the CG (`kdip_tpu` guidance.py:519-537)."""
    solver = {"inpainting": inpainting_mat, "gaussian_blur": deblur_mat,
              "motion_blur": deblur_mat,
              "super_resolution": super_resolution_mat,
              "colorization": colorization_mat}.get(op.name)
    if solver is None:
        raise NotImplementedError(f"no mat solver for operator {op.name!r}")
    return solver(op, y, x0_mean, theta0_var, ortho_tf, iso, cfg, u0=u0,
                  want_state=want_state)


def init_solver_state(op, x_shape, device="cpu"):
    """The zero warm-start state for cg_warm_start on NCHW images of
    x_shape: u has the shape of the solver's raw CG variable, in x-space
    for inpainting and deblurring, low-resolution for super-resolution,
    one channel for colorization (`kdip_tpu` guidance.py:540-554)."""
    B, C, H, W = x_shape
    if op.name == "super_resolution":
        sf = op.scale_factor
        shape = (B, C, H // sf, W // sf)
    elif op.name == "colorization":
        shape = (B, 1, H, W)
    else:
        shape = (B, C, H, W)
    return {"u": torch.zeros(shape, device=device), "iters": 0}


# ---------------------------------------------------------------------------
# The condition denoiser
# ---------------------------------------------------------------------------

def make_condition_denoiser(uncond_pred: Callable, x0_var_fn: Callable,
                            operator, measurement: Measurement,
                            cfg: GuidanceConfig, v2: bool = False,
                            with_info: bool = False,
                            ortho_tf: Optional[OrthoTransform] = None,
                            generator: Optional[torch.Generator] = None):
    """Builds `denoise(x, sigma, probes=None) -> hat_x0` for every guidance
    mode of GUIDANCE_MODES and MLE_MODES (ref: condition.py:83-131,
    `kdip_tpu` guidance.py:561-829); sigma is a host float. With with_info
    it returns (hat_x0, info): info["cg_resid"] is the worst CG relative
    residual |r|/|b| at exit of the call's solves (0.0 for closed-form and
    solver-free modes), info["cg_iters"] their iteration count. `ortho_tf`
    replaces the transform named by cfg.ortho_tf_type (a test's fake).

    stsl's Hutchinson probes (num_hutchinson_samples tensors broadcastable
    to x) and autoI's (cfg.num_probes Rademacher tensors of x's shape) come
    from the call's `probes`, else they are drawn from `generator`.

    With cfg.cg_warm_start (guidance I or II, a CG covariance, with_info)
    the call is `denoise(x, sigma, solver_state=st)`, st from
    `init_solver_state` or the previous call's info["solver_state"]: the
    solve starts from st["u"] (`kdip_tpu` guidance.py:747-770, 789-807).

    Every denoiser carries `denoise.loglikelihood(x, sigma, probes=None,
    lanczos_iters=25) -> (ll, cg_rel_resid)`, the measurement
    log-likelihood at the moments of (x, sigma) (`kdip_tpu`
    guidance.py:772-787; see autoi.measurement_loglikelihood)."""
    from . import autoi
    if ortho_tf is None:
        ortho_tf = OrthoTransform(cfg.ortho_tf_type)
    y = measurement.y
    guidance = cfg.guidance
    if guidance not in GUIDANCE_MODES + MLE_MODES:
        raise ValueError(f"Invalid guidance type: {guidance!r}.")
    kind = "switch" if v2 else _COV_KIND.get(cfg.x0_cov_type)
    if kind is None:
        raise ValueError(f"unrecognized posterior covariance type "
                         f"{cfg.x0_cov_type!r}")
    base = guidance.split("+")[0]
    need = {"dps": ("zeta",), "diffpir": ("lambda_",),
            "stsl": ("zeta", "eta", "num_hutchinson_samples")}.get(base, ())
    missing = [f for f in need if getattr(cfg, f) is None]
    if missing:
        raise ValueError(f"guidance {guidance!r} needs {missing}")
    if guidance == "autoI" and kind == "tensor":
        # kdip_tpu's autoI hands x0_var_fn no vjp (autoi.py:164), so tmpd's
        # variance fails its assert (guidance.py:187) when traced
        raise ValueError("autoI takes no tmpd covariance: its variance "
                         "needs the vjp of x0_mean, which autoI's single "
                         "backward does not provide")
    warm = cfg.cg_warm_start
    if warm:
        # kdip_tpu's asserts (guidance.py:789-795)
        if not with_info:
            raise ValueError("cg_warm_start needs the info-returning "
                             "denoiser (with_info=True)")
        if guidance not in ("I", "II"):
            raise ValueError(f"cg_warm_start applies to guidance I/II (CG "
                             f"solves), not {guidance!r}")
        if kind == "iso":
            raise ValueError(f"covariance {cfg.x0_cov_type!r} is closed-"
                             f"form (no CG); cg_warm_start has nothing to "
                             f"warm")
    thres = cfg.mle_sigma_thres
    vjp_pred = remat_pred(uncond_pred, cfg.remat_vjp)
    sac = cfg.remat_vjp == "conv_dots"

    def moments(x, sigma, grad: bool):
        """(x0_mean detached, aux, mean_vjp): mean_vjp(ct, retain) is the
        vjp of x0_mean at x, None where grad is False (the forward then
        runs under no_grad)."""
        if not grad:
            with torch.no_grad(), span("guidance.forward"):
                x0_mean, aux = uncond_pred(x, sigma)
            return x0_mean, aux, None
        x = x.detach().requires_grad_(True)
        with torch.enable_grad(), span("guidance.forward"):
            x0_mean, aux = vjp_pred(x, sigma)
        graph = [(x, x0_mean)]

        def mean_vjp(ct, retain=True):
            if not graph:
                # a selective-checkpoint region takes one backward: a
                # later vjp (tmpd's second) runs the region again
                xg = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    graph.append((xg, vjp_pred(xg, sigma)[0]))
            xg, out = graph.pop() if sac else graph[0]
            with span("guidance.vjp"):
                return torch.autograd.grad(
                    out, xg, grad_outputs=ct,
                    retain_graph=retain and not sac)[0]
        return x0_mean.detach(), aux, mean_vjp

    def solver_var(aux, sigma, mean_vjp, x_shape):
        """The variance the solve takes (ref: condition.py:170-171):
        theta0_var in the ortho basis if set, else x0_var; a host float
        for the iso covariances and above mle_sigma_thres."""
        var = x0_var_fn(aux, sigma, mean_vjp, x_shape)
        x0_var, theta0_var = var if v2 else (var, var)
        svar = x0_var if cfg.ortho_tf_type is None else theta0_var
        return svar.detach() if torch.is_tensor(svar) else svar

    def solve(x0m, svar, sigma, st=None):
        """"iso": the closed form (a tensor variance reduced to its mean);
        "tensor": CG; "switch": CG below mle_sigma_thres, the closed form
        at mle_var above (`kdip_tpu` guidance.py:616-659). Returns (mat,
        rel_resid, iterations, the warm-start state or None); with a
        state `st` the CG starts from st["u"]."""
        kw = {} if st is None else dict(u0=st["u"], want_state=True)
        with span("guidance.solve"):
            if kind == "iso":
                sv = svar
                if torch.is_tensor(svar):
                    host_read_counts["iso_mean"] += 1
                    with span("guidance.host_read"):
                        sv = float(_batch_mean(svar))
                out = mat_solver(operator, y, x0m, sv, ortho_tf, True, cfg,
                                 **kw)
            elif kind == "tensor" or sigma < thres:
                out = mat_solver(operator, y, x0m, svar, ortho_tf, False,
                                 cfg, **kw)
            else:
                out = mat_solver(operator, y, x0m, mle_var(sigma), ortho_tf,
                                 True, cfg, **kw)
        return out if st is not None else out + (None,)

    def s2(sigma):
        return _f32(np.float32(sigma) ** 2)

    def type_I(x, sigma, _, st=None):
        """ref: condition.py:167-174. tmpd's variance is the vjp of x0_mean
        with ones, taken on the graph the score's vjp reuses."""
        x0m, aux, mean_vjp = moments(x, sigma, True)
        mat, resid, iters, state = solve(
            x0m, solver_var(aux, sigma, mean_vjp, x.shape), sigma, st)
        return x0m + s2(sigma) * mean_vjp(mat, False), resid, iters, state

    def type_II(x, sigma, _, st=None):
        """ref: condition.py:176-183: x0_mean + W^-1(W mat * svar). Only
        tmpd's variance needs the vjp. A tensor svar runs ot_covariance
        (for "dwt" one fused no-mask launch); with a scalar the transform
        cancels, mat * svar."""
        x0m, aux, mean_vjp = moments(x, sigma, kind == "tensor")
        svar = solver_var(aux, sigma, mean_vjp, x.shape)
        mat, resid, iters, state = solve(x0m, svar, sigma, st)
        step = (ot_covariance(ortho_tf, svar)(mat) if torch.is_tensor(svar)
                else mat * svar)
        return x0m + step, resid, iters, state

    def dps(x, sigma, _, st=None):
        """ref: condition.py:140-148: the gradient of -|y - A x0_mean| (the
        norm over the whole call) through the operator and the UNet,
        times zeta."""
        x0m, _, mean_vjp = moments(x, sigma, True)
        x0d = x0m.requires_grad_(True)
        with torch.enable_grad():
            norm = _batch_norm(y - operator.forward(x0d))
        g, = torch.autograd.grad(norm, x0d)
        score = mean_vjp(-g, False) * cfg.zeta
        return x0m.detach() + s2(sigma) * score, 0.0, 0, None

    def pgdm(x, sigma, _, st=None):
        """ref: condition.py:150-157: the closed form at mle_var(sigma),
        the vjp scaled by it."""
        x0m, _, mean_vjp = moments(x, sigma, True)
        x0_var = mle_var(sigma)
        with span("guidance.solve"):
            mat, resid, iters = mat_solver(operator, y, x0m, x0_var,
                                           ortho_tf, True, cfg)
        return (x0m + s2(sigma) * (mean_vjp(mat, False) * x0_var),
                resid, iters, None)

    def diffpir(x, sigma, _, st=None):
        """ref: condition.py:159-165: no vjp; x0_mean + mat * sigma^2 /
        lambda_."""
        x0m, _, _ = moments(x, sigma, False)
        x0_var = _f32(np.float32(sigma) ** 2 / np.float32(cfg.lambda_))
        with span("guidance.solve"):
            mat, resid, iters = mat_solver(operator, y, x0m, x0_var,
                                           ortho_tf, True, cfg)
        return x0m + mat * x0_var, resid, iters, None

    def stsl(x, sigma, eps_list, st=None):
        """ref: condition.py:185-208: the gradient at x of zeta *
        (-|y - A x0_mean|) + eta / x.numel() * the mean over the probes
        of -sigma^2 <x0_mean(x + eps) - x0_mean(x), eps>, through
        1 + num_hutchinson_samples UNet forwards."""
        if eps_list is None:
            eps_list = [torch.randn(x.shape, generator=generator,
                                    device=x.device, dtype=x.dtype)
                        for _ in range(cfg.num_hutchinson_samples)]
        if len(eps_list) != cfg.num_hutchinson_samples:
            raise ValueError(f"{len(eps_list)} probes, num_hutchinson_"
                             f"samples {cfg.num_hutchinson_samples}")
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            x0_mean, _ = uncond_pred(x, sigma)
            first = -_batch_norm(y - operator.forward(x0_mean))
            second = 0.0
            for eps in eps_list:
                inc, _ = uncond_pred(x + eps, sigma)
                second = second - _batch_sum(
                    torch.sum((inc - x0_mean) * eps)) * s2(sigma)
            second = second / cfg.num_hutchinson_samples
            loss = cfg.zeta * first + (cfg.eta / _batch_numel(x)) * second
        g, = torch.autograd.grad(loss, x)
        return x0_mean.detach() + s2(sigma) * g, 0.0, 0, None

    def auto_I(x, sigma, probes, st=None):
        """ref: condition.py:133-138: the gradient of the exact Gaussian
        log-likelihood, by CG and Hutchinson probes (autoi.py)."""
        if probes is None:
            probes = [autoi.rademacher(x.shape, generator, x.device, x.dtype)
                      for _ in range(cfg.num_probes)]
        if len(probes) != cfg.num_probes:
            raise ValueError(f"{len(probes)} probes, num_probes "
                             f"{cfg.num_probes}")
        return autoi.auto_type_I_guidance(
            uncond_pred, x0_var_fn, operator, y, cfg, x, sigma, ortho_tf,
            probes, v2=v2) + (None,)

    def uncond(x, sigma, _, st=None):
        return moments(x, sigma, False)[0], 0.0, 0, None

    impls = {"uncond": uncond, "I": type_I, "II": type_II, "dps": dps,
             "pgdm": pgdm, "diffpir": diffpir, "stsl": stsl, "autoI": auto_I}

    def denoise(x, sigma, probes=None, solver_state=None):
        """`probes`: stsl's or autoI's probes for this call (see above);
        `solver_state`: the warm start's state (cg_warm_start only)."""
        sigma = float(sigma)
        if warm and solver_state is None:
            raise ValueError("the cg_warm_start denoiser takes solver_state")
        # the +mle modes: Type-I below mle_sigma_thres, the base mode above
        fn = (type_I if guidance in MLE_MODES and sigma < thres
              else impls[base])
        with span("guidance.nfe"):
            out, resid, iters, state = fn(x, sigma, probes,
                                          solver_state if warm else None)
            out = out.clamp(-1, 1)
        if not with_info:
            return out
        info = {"cg_resid": resid, "cg_iters": iters}
        if warm:
            info["solver_state"] = state
        return out, info

    def loglikelihood(x, sigma, probes=None, lanczos_iters: int = 25):
        """The scalar log N(y; A x0_mean, K) at the moments of (x, sigma)
        and the CG's relative residual (see
        autoi.measurement_loglikelihood); `probes` are SLQ's num_probes
        Rademacher tensors of y's shape, else drawn from `generator`.
        Diagnostic only: no guidance mode consumes the value."""
        sigma = float(sigma)
        x0m, aux, mean_vjp = moments(x, sigma, kind == "tensor")
        svar = solver_var(aux, sigma, mean_vjp, x.shape)
        return autoi.measurement_loglikelihood(
            operator, ortho_tf, y, x0m, svar, cfg, probes=probes,
            generator=generator, lanczos_iters=lanczos_iters)

    denoise.loglikelihood = loglikelihood
    return denoise
