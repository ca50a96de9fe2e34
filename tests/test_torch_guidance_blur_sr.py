"""The port's deblur, super-resolution and colorization likelihood solves,
and Type-I guided denoising on them with the Convert, tmpd and DWT-Var
covariances (`kdip_tpu_torch.guidance`), against `kdip_tpu`'s on the same
inputs, NCHW against NHWC.

Tolerances, for each check:
- the solves (`test_mat_solver_matches`): mat within SOLVE_TOL = 1e-4 of
  its largest entry, the same CG iteration count within 1, and the exit
  residual within 10% (float32 FFTs and sums in other orders; measured:
  mat within 1e-5 relative, the same iteration counts, residuals within
  2%, the CG stopping at |r| <= 1e-4 |b| wherever the last rounding leaves
  it);
- the wide-range covariance (`test_deblur_wide_range_matches_dense`): the
  float32 CG against a float64 dense solve, within 2e-3 of the largest
  entry, as `tests/test_cg_wide_variance.py` holds `kdip_tpu`;
- one guided denoise (`test_guided_denoise_matches`): hat_x0 and the
  CG exit residuals per configuration in CONFIGS, with the reasons there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import diffusion as jd
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu.models import adm as jadm
from kdip_tpu.ops.transforms import OrthoTransform as JOT
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params

S = 32
UNET = dict(SMALL_UNET, image_size=S)
SOLVE_TOL = 1e-4
# the configs/ yamls at 32 px, blur kernels cut to 9 px (61 px does not fit)
OPS = {
    "gaussian_blur": dict(in_shape=(1, 3, S, S), kernel_size=9,
                          intensity=3.0, sigma_s=0.05),
    "motion_blur": dict(in_shape=(1, 3, S, S), kernel_size=9, seed=0,
                        sigma_s=0.05),
    "super_resolution": dict(in_shape=(1, 3, S, S), scale_factor=4,
                             sigma_s=0.05),
    "colorization": dict(sigma_s=0.05),
}


def _problem(name, seed=0):
    """(jax op, port op, y, x0_mean, theta) on NHWC numpy arrays: y = A x +
    0.05 n for a random x, x0_mean another random image, theta a
    Convert-like variance in [0.05, 0.15)."""
    jop = jo.get_operator(name, **OPS[name])
    top = P.operators.get_operator(name, device="cpu", **OPS[name])
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    x0m = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    ax = np.asarray(jop.forward(jnp.asarray(x)))
    y = (ax + 0.05 * rng.standard_normal(ax.shape)).astype(np.float32)
    theta = (0.1 * rng.uniform(0.5, 1.5, (1, S, S, 3))).astype(np.float32)
    return jop, top, y, x0m, theta


SOLVES = [(n, iso, ot, pc) for n in OPS for iso, ot, pc in (
    (True, None, False), (False, None, False), (False, None, True),
    (False, "dwt", False), (False, "dwt", True))]


@pytest.mark.parametrize("name,iso,ortho,precond", SOLVES)
def test_mat_solver_matches(name, iso, ortho, precond):
    """deblur_mat / super_resolution_mat / colorization_mat through
    mat_solver: the closed form at a scalar variance, and CG with a tensor
    variance in the pixel and the DWT basis (the fused matvec's plain
    version, with its contiguity checks), with and without
    cg_precondition."""
    jop, top, y, x0m, theta = _problem(name)
    jcfg = jg.GuidanceConfig(cg_precondition=precond, cg_warn=False)
    tcfg = P.guidance.GuidanceConfig(cg_precondition=precond)
    th_j = jnp.float32(0.3) if iso else jnp.asarray(theta)
    th_t = float(np.float32(0.3)) if iso else nchw(theta)
    mat_j, r_j, st = jg.mat_solver(jop, jnp.asarray(y), jnp.asarray(x0m),
                                   th_j, JOT(ortho), iso, jcfg,
                                   want_state=True)
    mat_t, r_t, it = P.guidance.mat_solver(
        top, nchw(y), nchw(x0m), th_t, P.ops.transforms.OrthoTransform(ortho),
        iso, tcfg)
    mat_j = np.asarray(mat_j)
    assert mat_t.shape == (1, 3, S, S)
    np.testing.assert_allclose(nhwc(mat_t), mat_j,
                               atol=SOLVE_TOL * np.abs(mat_j).max())
    if iso:
        assert (r_t, it) == (0.0, 0) and float(r_j) == 0
    else:
        assert abs(it - int(st["iters"])) <= 1 and it > 0
        assert 0 < r_t <= 1e-4
        np.testing.assert_allclose(r_t, float(r_j), rtol=0.1)


def test_mat_solver_dispatch():
    _, top, y, x0m, _ = _problem("gaussian_blur")
    cfg = P.guidance.GuidanceConfig()
    ot = P.ops.transforms.OrthoTransform()
    motion = P.operators.get_operator("motion_blur", device="cpu",
                                      **OPS["motion_blur"])
    for op in (top, motion):
        got = P.guidance.mat_solver(op, nchw(y), nchw(x0m), 0.3, ot, True, cfg)
        want = P.guidance.deblur_mat(op, nchw(y), nchw(x0m), 0.3, ot, True,
                                     cfg)
        assert torch.equal(got[0], want[0])
    noise = P.operators.get_operator("noise", device="cpu")
    with pytest.raises(NotImplementedError, match="no mat solver"):
        P.guidance.mat_solver(noise, nchw(y), nchw(x0m), 0.3, ot, True, cfg)


def _dense_deblur(op, y, x0m, theta, W=None):
    """A^T (s2 I + A C A^T)^{-1} (y - A x0_mean) in float64, C = diag(theta)
    (or W^T diag(theta) W), each channel densely: A is the circular
    convolution of op's OTF, as a [HW, HW] matrix."""
    H = y.shape[-2]
    FB = op.FB.numpy().astype(np.complex128)
    eye = np.eye(H * H).reshape(H * H, H, H)
    A = np.fft.ifft2(FB * np.fft.fft2(eye)).real.reshape(H * H, H * H).T
    s2 = np.float64(np.float32(0.05)) ** 2
    out = np.empty_like(y, dtype=np.float64)
    for c in range(3):
        t = np.diag(theta[0, c].reshape(-1).astype(np.float64))
        C = t if W is None else W.T @ t @ W
        M = s2 * np.eye(H * H) + A @ C @ A.T
        b = (y[0, c] - (A @ x0m[0, c].reshape(-1)).reshape(H, H)).reshape(-1)
        out[0, c] = (A.T @ np.linalg.solve(M, b)).reshape(H, H)
    return out


@pytest.mark.parametrize("ortho", [None, "dwt"])
def test_deblur_wide_range_matches_dense(ortho):
    """A tmpd-like variance, 10^U(-2, 3): five orders of magnitude, at
    16 px, in the pixel basis and through the DWT (the fused matvec's
    no-mask mode), against a float64 dense solve."""
    H = 16
    op = P.operators.get_operator(
        "gaussian_blur", device="cpu", in_shape=(1, 3, H, H), sigma_s=0.05,
        kernel=P.ops.kernels.gaussian_kernel(5, 1.2))
    rng = np.random.RandomState(0)
    x0m = rng.uniform(-1, 1, (1, 3, H, H)).astype(np.float32)
    y = (op.forward(torch.from_numpy(x0m)).numpy()
         + 0.05 * rng.standard_normal((1, 3, H, H))).astype(np.float32)
    theta = (10.0 ** rng.uniform(-2, 3, (1, 3, H, H))).astype(np.float32)
    W = None
    if ortho == "dwt":
        eye = torch.eye(H * H, dtype=torch.float64).reshape(H * H, 1, H, H)
        W = P.ops.dwt.dwt2_plain(eye, 3).reshape(H * H, H * H).T.numpy()
    want = _dense_deblur(op, y, x0m, theta, W)
    cfg = P.guidance.GuidanceConfig("I", "tmpd")
    assert not cfg.cg_precondition  # harmful on wide ranges: off
    mat, resid, iters = P.guidance.mat_solver(
        op, torch.from_numpy(y), torch.from_numpy(x0m),
        torch.from_numpy(theta), P.ops.transforms.OrthoTransform(ortho),
        False, cfg)
    scale = np.abs(want).max()
    np.testing.assert_allclose(mat.numpy() / scale, want / scale, atol=2e-3)
    assert iters > 20


# ---------------------------------------------------------------------------
# one Type-I guided denoise against kdip_tpu's
# ---------------------------------------------------------------------------

# name: (operator, v2, guidance config, sigmas, atol on hat_x0, largest
# ratio of the two CG exit residuals), each with its reason. A CG stops at
# the first iteration whose |r| <= 1e-4 |b|; where it runs tens of
# iterations, rounding can move that iteration by one, and the exit
# residual by the last iteration's contraction, so long solves are held
# to a ratio of 2, short ones (<= 5 iterations) to 10%.
CONFIGS = {
    # Convert on gaussian deblur, either side of the 0.2 threshold: float32
    # differences in the vjp, scaled by sigma^2 above the threshold
    # (measured 4e-7 below, 6e-6 above; 5 CG iterations, residuals equal)
    "gaussian_deblur_convert": ("gaussian_blur", False,
                                dict(guidance="I", x0_cov_type="convert"),
                                (0.06, 0.6), 1e-3, 1.1),
    # SR x4 Convert, both sides: the same (measured 4e-7 / 5e-6; 3 CG
    # iterations, residuals within 3e-6 relative)
    "sr4x_convert": ("super_resolution", False,
                     dict(guidance="I", x0_cov_type="convert"),
                     (0.06, 0.6), 1e-3, 1.1),
    # tmpd at one sigma above Convert's threshold (tmpd runs CG at every
    # sigma): its variance is itself a float32 vjp that the solve then
    # amplifies by sigma^2 (measured 2.1e-4; 39 CG iterations, residuals
    # 6.3e-5 against 9.8e-5)
    "gaussian_deblur_tmpd": ("gaussian_blur", False,
                             dict(guidance="I", x0_cov_type="tmpd"),
                             (0.5,), 2e-3, 2.0),
    # DWT-Var on gaussian deblur, either side of 1.0: the V2 head's learned
    # variances through the DWT below, the closed form above (measured
    # 2.1e-5 / 3.3e-4; 26 CG iterations, residuals 7.4e-5 against 5.7e-5)
    "gaussian_deblur_dwt_var": ("gaussian_blur", True,
                                dict(guidance="I", ortho_tf_type="dwt",
                                     mle_sigma_thres=1.0),
                                (0.3, 3.0), 1e-3, 2.0),
}


def build_denoisers(name, seed=3):
    """(jax denoise, port denoise) of one configuration with the same random
    weights, measurement and operator."""
    op_name, v2, gcfg = CONFIGS[name][:3]
    unet = jadm.ADMUNet(**UNET)
    jm = jadm.ADMUNetV2(unet=unet) if v2 else unet
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=seed)
    tm = P.adm.ADMUNet(**UNET, device="cpu")
    if v2:
        tm = P.adm.ADMUNetV2(tm)
    tm.load_state_dict(P.weights.from_jax_params(params))
    jop, top, y, _, _ = _problem(op_name, seed)

    jcfg = jg.GuidanceConfig(**gcfg, cg_warn=False)
    tcfg = P.guidance.GuidanceConfig(**gcfg)
    jmake = jg.make_openai_v2_uncond if v2 else jg.make_openai_uncond
    ju, jv = jmake(lambda p, x, t: jm.apply({"params": p}, x,
                                            jnp.asarray(t, jnp.float32)),
                   jd.make_diffusion(1000, "linear"), jcfg)
    jden = jax.jit(jg.make_condition_denoiser(
        ju, jv, jop, jo.Measurement(y=jnp.asarray(y)), jcfg, params=params,
        v2=v2, with_info=True))
    tmake = (P.guidance.make_openai_v2_uncond if v2
             else P.guidance.make_openai_uncond)
    tu, tv = tmake(tm, P.diffusion.make_diffusion(1000, "linear",
                                                  device="cpu"), tcfg)
    tden = P.guidance.make_condition_denoiser(
        tu, tv, top, P.operators.Measurement(y=nchw(y)), tcfg, v2=v2,
        with_info=True)
    return jden, tden


@pytest.mark.parametrize("name", list(CONFIGS))
def test_guided_denoise_matches(name):
    """hat_x0 within the configuration's tolerance; cg_resid 0 for the
    closed form, else both solves converged (0 < r <= 1e-4) and their
    residuals within the configuration's ratio."""
    _, _, gcfg, sigmas, atol, ratio = CONFIGS[name]
    jden, tden = build_denoisers(name)
    thres = gcfg.get("mle_sigma_thres", 0.2)
    tensor = gcfg.get("x0_cov_type") == "tmpd"
    rng = np.random.RandomState(11)
    xs = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    for sigma in sigmas:
        x = xs + sigma * rng.standard_normal(xs.shape).astype(np.float32)
        out_j, info_j = jden(jnp.asarray(x), jnp.float32(sigma))
        out_t, info_t = tden(nchw(x), sigma)
        np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=atol)
        r_j, r_t = float(info_j["cg_resid"]), info_t["cg_resid"]
        if tensor or sigma < thres:
            assert 0 < r_t <= 1e-4 and 0 < r_j <= 1e-4
            assert info_t["cg_iters"] > 0
            assert max(r_t, r_j) <= ratio * min(r_t, r_j), (r_t, r_j)
        else:
            assert info_t == {"cg_resid": 0.0, "cg_iters": 0} and r_j == 0


def test_tmpd_variance_is_the_ones_vjp():
    """tmpd's x0_var_fn: sigma^2 times the vjp of x0_mean with ones, taken
    on a retained graph, so the score's vjp can follow on the same graph."""
    tm = P.adm.ADMUNet(**UNET, device="cpu")
    torch.manual_seed(0)
    for p in tm.parameters():
        torch.nn.init.normal_(p, std=0.05)
    tab = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    cfg = P.guidance.GuidanceConfig("I", "tmpd")
    uncond, var_fn = P.guidance.make_openai_uncond(tm, tab, cfg)
    sigma = 0.7
    x = (0.5 * torch.randn(1, 3, S, S)).requires_grad_(True)
    x0_mean, aux = uncond(x, sigma)

    def mean_vjp(ct):
        return torch.autograd.grad(x0_mean, x, ct, retain_graph=True)[0]
    var = var_fn(aux, sigma, mean_vjp, x.shape)
    want = torch.autograd.grad(x0_mean.sum(), x, retain_graph=True)[0]
    assert torch.allclose(var, want * float(np.float32(sigma) ** 2))
    # the graph survives for the score's vjp
    torch.autograd.grad(x0_mean, x, torch.ones_like(x0_mean))
