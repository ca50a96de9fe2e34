"""A short posterior-sampling trajectory of the port against `kdip_tpu`'s:
`sampling_api.build_posterior_sampler` with the V2 DWT-Var configuration on
p=0.5 inpainting, 4 Heun steps with churn, 2 samples against one
measurement (the per-sample loop), the initial x and the churn noise
replayed from `kdip_tpu`'s key splits (sampling_api.py:133-135,
samplers.py:137-138)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import diffusion as jd
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu import sampling_api as jsa
from kdip_tpu.models import adm as jadm
from test_torch_port import (SMALL_UNET, nchw, nhwc, one_torch_thread,  # noqa: F401
                             random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = SMALL_UNET["image_size"]
STEPS, N = 4, 2
# At a high sigma, hat_x0 = x0_mean + sigma^2 * score cancels terms of size
# sigma^2 |mat| in float32, so an unclipped pixel can differ by ~1e-2
# between the two frameworks at sigma ~16 (measured), and the trajectory
# carries that to its end. sigma_max 2 keeps every NFE below sigma 3, where
# that cancellation stays under 4e-4; the steps still cover churn, the
# closed-form solve above the threshold, CG below it, and the Euler step.
SCFG = dict(steps=STEPS, sigma_max=2.0)
GCFG = dict(guidance="I", ortho_tf_type="dwt", mle_sigma_thres=1.0)
OP_CFG = dict(name="inpainting", sigma_s=0.05,
              mask_opt=dict(mask_type="random", mask_prob_range=(0.5, 0.5),
                            image_size=S))


def _jax_draws(key, size=S):
    """The standard-normal draws kdip_tpu's Heun sampler makes from `key`."""
    k_init, k = jax.random.split(key)
    init = jax.random.normal(k_init, (N, size, size, 3))
    churn = []
    for _ in range(STEPS):
        k, k_churn, _, _ = jax.random.split(k, 4)
        churn.append(nchw(jax.random.normal(k_churn, (N, size, size, 3))))
    return nchw(init), churn


def test_heun_trajectory_matches():
    """Final samples within 2e-3 and cg_max_residual within 0.1%: float32
    on both sides, with differences from summation order carried through 7
    guided NFEs, the sampler adding each NFE's difference scaled by its
    step (measured: 3e-4 on the samples, 2e-5 relative on the residual)."""
    jm = jadm.ADMUNetV2(unet=jadm.ADMUNet(**SMALL_UNET))
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=5)
    tm = P.adm.ADMUNetV2(P.adm.ADMUNet(**SMALL_UNET, device="cpu"))
    tm.load_state_dict(P.weights.from_jax_params(params))

    jop = jo.get_operator(seed=1, **OP_CFG)
    top = P.operators.get_operator(seed=1, device="cpu", **OP_CFG)
    rng = np.random.RandomState(2)
    x0 = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    y = (x0 + 0.05 * rng.standard_normal(x0.shape).astype(np.float32)
         ) * np.asarray(jop.mask)

    jsampler = jsa.build_posterior_sampler(
        lambda p, x, t: jm.apply({"params": p}, x, jnp.asarray(t, jnp.float32)),
        jd.make_diffusion(1000, "linear"), jop, jg.GuidanceConfig(**GCFG),
        jsa.SamplerConfig(**SCFG), v2=True, image_size=S)
    key = jax.random.key(7)
    out_j, info_j = jax.jit(
        lambda p, m, k: jsampler(p, m, k, n=N, return_info=True))(
            params, jo.Measurement(y=jnp.asarray(y)), key)

    tsampler = P.sampling_api.build_posterior_sampler(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), top,
        P.guidance.GuidanceConfig(**GCFG),
        P.sampling_api.SamplerConfig(**SCFG), v2=True, image_size=S,
        device="cpu")
    init, churn = _jax_draws(key)
    out_t, info_t = tsampler(P.operators.Measurement(y=nchw(y)), n=N,
                             init_noise=init, noise_fn=churn.__getitem__,
                             return_info=True)
    assert out_t.shape == (N, 3, S, S) and torch.isfinite(out_t).all()
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=2e-3)
    r_j = float(info_j["cg_max_residual"])
    assert 0 < r_j <= 1e-4 and info_t["cg_total_iters"] > 0
    np.testing.assert_allclose(info_t["cg_max_residual"], r_j, rtol=1e-3)


def test_tmpd_deblur_trajectory_matches():
    """The V1 UNet with the tmpd covariance on gaussian deblur (a 9 px
    kernel of std 3.0 at 16 px), 4 Heun steps with churn from sigma_max
    0.7: CG at every one of the 7 guided NFEs. tmpd's "variance" is sigma^2
    times the Jacobian's column sums, which random weights make negative
    at some pixels (7% at sigma 0.3, 35% at sigma 2); from sigma ~2 the
    system is indefinite and neither package's CG converges, so the
    trajectory stays below sigma 1 (sigma_hat <= 0.99), where both do.
    Final samples within 2e-3 and both worst CG residuals converged:
    float32 on both sides, the variance itself a vjp whose rounding the
    solves carry (measured: 1.3e-4 on the samples)."""
    gcfg = dict(guidance="I", x0_cov_type="tmpd")
    scfg = dict(SCFG, sigma_max=0.7)
    op_cfg = dict(in_shape=(1, 3, S, S), kernel_size=9, intensity=3.0,
                  sigma_s=0.05)
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=6)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))

    jop = jo.get_operator("gaussian_blur", **op_cfg)
    top = P.operators.get_operator("gaussian_blur", device="cpu", **op_cfg)
    rng = np.random.RandomState(3)
    x0 = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    y = (np.asarray(jop.forward(jnp.asarray(x0)))
         + 0.05 * rng.standard_normal(x0.shape)).astype(np.float32)

    jsampler = jsa.build_posterior_sampler(
        lambda p, x, t: jm.apply({"params": p}, x,
                                 jnp.asarray(t, jnp.float32)),
        jd.make_diffusion(1000, "linear"), jop,
        jg.GuidanceConfig(**gcfg, cg_warn=False), jsa.SamplerConfig(**scfg),
        image_size=S)
    key = jax.random.key(8)
    out_j, info_j = jax.jit(
        lambda p, m, k: jsampler(p, m, k, n=N, return_info=True))(
            params, jo.Measurement(y=jnp.asarray(y)), key)

    tsampler = P.sampling_api.build_posterior_sampler(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), top,
        P.guidance.GuidanceConfig(**gcfg),
        P.sampling_api.SamplerConfig(**scfg), image_size=S, device="cpu")
    init, churn = _jax_draws(key)
    out_t, info_t = tsampler(P.operators.Measurement(y=nchw(y)), n=N,
                             init_noise=init, noise_fn=churn.__getitem__,
                             return_info=True)
    assert out_t.shape == (N, 3, S, S) and torch.isfinite(out_t).all()
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=2e-3)
    assert 0 < float(info_j["cg_max_residual"]) <= 1e-4
    assert 0 < info_t["cg_max_residual"] <= 1e-4
    # every guided NFE of every sample ran at least one CG iteration
    assert info_t["cg_total_iters"] >= N * (2 * STEPS - 1)


SB = 32


def _batched_case(cov: str):
    """(kdip_tpu sampler and params, the port's sampler, the measurement)
    of the batched path at 32 px: Type-I Convert on the V1 UNet, or DWT-Var
    on the V2 UNet, p=0.5 inpainting."""
    unet = dict(SMALL_UNET, image_size=SB)
    v2 = cov == "dwt_var"
    gcfg = dict(GCFG) if v2 else dict(guidance="I", x0_cov_type="convert")
    scfg = dict(SCFG, per_sample_map=False)
    op_cfg = dict(OP_CFG, mask_opt=dict(OP_CFG["mask_opt"], image_size=SB))
    jm = jadm.ADMUNet(**unet)
    tm = P.adm.ADMUNet(**unet, device="cpu")
    if v2:
        jm, tm = jadm.ADMUNetV2(unet=jm), P.adm.ADMUNetV2(tm)
    params = random_flax_params(jm.init, jnp.zeros((1, SB, SB, 3)),
                                jnp.zeros((1,)), seed=9)
    tm.load_state_dict(P.weights.from_jax_params(params))
    jop = jo.get_operator(seed=1, **op_cfg)
    top = P.operators.get_operator(seed=1, device="cpu", **op_cfg)
    rng = np.random.RandomState(4)
    x0 = rng.uniform(-1, 1, (1, SB, SB, 3)).astype(np.float32)
    y = (x0 + 0.05 * rng.standard_normal(x0.shape).astype(np.float32)
         ) * np.asarray(jop.mask)
    jsampler = jsa.build_posterior_sampler(
        lambda p, x, t: jm.apply({"params": p}, x,
                                 jnp.asarray(t, jnp.float32)),
        jd.make_diffusion(1000, "linear"), jop, jg.GuidanceConfig(**gcfg),
        jsa.SamplerConfig(**scfg), v2=v2, image_size=SB)
    tsampler = P.sampling_api.build_posterior_sampler(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), top,
        P.guidance.GuidanceConfig(**gcfg),
        P.sampling_api.SamplerConfig(**scfg), v2=v2, image_size=SB,
        device="cpu")
    return jsampler, params, tsampler, y


@pytest.mark.parametrize("cov,resid_rtol", [("convert", 1e-2),
                                            ("dwt_var", 1e-3)])
def test_batched_trajectory_matches(cov, resid_rtol):
    """per_sample_map=False, n=2 against one measurement, 32 px: one
    UNet call and one CG solve over both samples a guided NFE, in both
    packages, the init and churn noise replayed from kdip_tpu's key.
    Samples within the per-sample case's 2e-3 (measured 6.7e-4 Convert,
    6.5e-4 DWT-Var). The worst CG residual, which sits just under the
    1e-4 stopping tolerance, within the per-sample case's 0.1% for
    DWT-Var (measured 0.009%) and 1% for Convert: Convert's per-sample
    path at this size already differs by 0.71% (9.79e-5 against 9.72e-5),
    its batched path by 0.19%."""
    jsampler, params, tsampler, y = _batched_case(cov)
    key = jax.random.key(11)
    out_j, info_j = jax.jit(
        lambda p, m, k: jsampler(p, m, k, n=N, return_info=True))(
            params, jo.Measurement(y=jnp.asarray(y)), key)
    init, churn = _jax_draws(key, SB)
    out_t, info_t = tsampler(P.operators.Measurement(y=nchw(y)), n=N,
                             init_noise=init, noise_fn=churn.__getitem__,
                             return_info=True)
    assert out_t.shape == (N, 3, SB, SB) and torch.isfinite(out_t).all()
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=2e-3)
    r_j = float(info_j["cg_max_residual"])
    assert 0 < r_j <= 1e-4 and 0 < info_t["cg_max_residual"] <= 1e-4
    assert info_t["cg_total_iters"] > 0
    np.testing.assert_allclose(info_t["cg_max_residual"], r_j,
                               rtol=resid_rtol)
