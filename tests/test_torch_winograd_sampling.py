"""The slice, guided sampling through the port's `winograd=True` ADM
torso, against `kdip_tpu`'s on the CPU: one Convert guided denoise on each
side of the 0.2 threshold, and a 2-step Heun trajectory through
`sampling_api.build_posterior_sampler` with `kdip_tpu`'s noise injected.

`kdip_tpu` runs its Winograd convs through the jnp formulation here
(KDIP_WINOGRAD_IMPL=jnp, which its dispatcher reads at trace time,
ops/experimental/winograd.py:143): a guided denoise through the Pallas
kernel in interpret mode would take minutes to compile. The jnp form rounds
its transforms like the kernel but for the order of its adds.

The torso is float16 on both sides. With random weights a guided denoise
amplifies the torso's rounding through the vjp (the closed-form score is
scaled by 1/(sigma_s^2 + var)): in bfloat16 even the two frameworks'
*direct* torsos give hat_x0 up to 1.7 apart from the float32 torso's
(measured, at sigma 0.6), so no bf16 bar could tell a fault from noise.
The Winograd path runs the same code in float16 with 3 more mantissa bits;
there every variant stays within 0.03 of float32 (measured)."""

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
from kdip_tpu.utils import precast_inference_params
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params

S = SMALL_UNET["image_size"]
OP_CFG = dict(name="inpainting", sigma_s=0.05,
              mask_opt=dict(mask_type="random", mask_prob_range=(0.5, 0.5),
                            image_size=S))
GCFG = dict(guidance="I", x0_cov_type="convert")
TOL = 5e-2  # on hat_x0 in [-1, 1]: the drift bound of test_winograd.py:151


@pytest.fixture
def jnp_winograd(monkeypatch):
    monkeypatch.setenv("KDIP_WINOGRAD_IMPL", "jnp")


def build(seed):
    """The JAX model_apply and params, and the port's model, with the same
    random weights, float16 torso, winograd=True; the operator pair and a
    measurement."""
    jm = jadm.ADMUNet(**SMALL_UNET, dtype=jnp.float16, winograd=True)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=seed)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu", winograd=True)
    tm.load_state_dict(P.weights.from_jax_params(params))
    P.weights.precast_inference(tm, torch.float16)
    jop = jo.get_operator(seed=0, **OP_CFG)
    top = P.operators.get_operator(seed=0, device="cpu", **OP_CFG)
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    y = (x0 + 0.05 * rng.standard_normal(x0.shape).astype(np.float32)
         ) * np.asarray(jop.mask)

    def japply(p, x, t):
        return jm.apply({"params": p}, x, jnp.asarray(t, jnp.float32))
    return (japply, precast_inference_params(params, jnp.float16), tm,
            jop, top, y)


def test_convert_denoise_matches(jnp_winograd):
    """hat_x0 within TOL on each side of the threshold (measured 0.024 at
    sigma 0.06, 0.026 at 0.6); below it both CG solves converge
    (|r|/|b| <= 1e-4) with residuals within 10% (the two systems differ by
    the torso drift of x0_var; measured 1.4%), above it both are closed
    form."""
    japply, params, tm, jop, top, y = build(seed=3)
    jcfg = jg.GuidanceConfig(**GCFG)
    tcfg = P.guidance.GuidanceConfig(**GCFG)
    ju, jv = jg.make_openai_uncond(japply, jd.make_diffusion(1000, "linear"),
                                   jcfg)
    jden = jax.jit(jg.make_condition_denoiser(
        ju, jv, jop, jo.Measurement(y=jnp.asarray(y)), jcfg, params=params,
        with_info=True))
    tu, tv = P.guidance.make_openai_uncond(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), tcfg)
    tden = P.guidance.make_condition_denoiser(
        tu, tv, top, P.operators.Measurement(y=nchw(y)), tcfg,
        with_info=True)
    xs = np.random.RandomState(11).standard_normal((1, S, S, 3)
                                                   ).astype(np.float32)
    for sigma in (0.06, 0.6):
        out_j, info_j = jden(jnp.asarray(xs * sigma), jnp.float32(sigma))
        out_t, info_t = tden(nchw(xs * sigma), sigma)
        out_j = np.asarray(out_j)
        assert np.abs(out_j).max() > 0.5
        assert np.abs(nhwc(out_t) - out_j).max() <= TOL
        r_j = float(info_j["cg_resid"])
        if sigma < 0.2:
            assert 0 < info_t["cg_resid"] <= 1e-4 and 0 < r_j <= 1e-4
            assert info_t["cg_iters"] > 0
            np.testing.assert_allclose(info_t["cg_resid"], r_j, rtol=0.1)
        else:
            assert info_t == {"cg_resid": 0.0, "cg_iters": 0} and r_j == 0


def test_heun_trajectory_matches(jnp_winograd):
    """2 Heun steps with churn from sigma_max 0.1 (3 NFEs, each a CG
    solve: at sigma_hat 0.141 and twice at 0.01), 2 samples against one
    measurement through the per-sample loop, the initial x and the churn
    noise replayed from kdip_tpu's key splits (samplers.py:137-138).
    Final samples within TOL (measured 0.027), cg_max_residual converged
    on both sides. The trajectory starts below the threshold because the
    closed form at sigma_hat 1.41 scales the score far past [-1, 1]: the
    clamp then flips a few pixels between +1 and -1 on any rounding
    difference, in the direct float16 torsos too (measured); the denoise
    test above covers the closed form."""
    steps, n = 2, 2
    japply, params, tm, jop, top, y = build(seed=5)
    scfg = dict(steps=steps, sigma_max=0.1)
    jsampler = jsa.build_posterior_sampler(
        japply, jd.make_diffusion(1000, "linear"), jop,
        jg.GuidanceConfig(**GCFG), jsa.SamplerConfig(**scfg), image_size=S)
    key = jax.random.key(7)
    out_j, info_j = jax.jit(
        lambda p, m, k: jsampler(p, m, k, n=n, return_info=True))(
            params, jo.Measurement(y=jnp.asarray(y)), key)

    k_init, k = jax.random.split(key)
    init = nchw(jax.random.normal(k_init, (n, S, S, 3)))
    churn = []
    for _ in range(steps):
        k, k_churn, _, _ = jax.random.split(k, 4)
        churn.append(nchw(jax.random.normal(k_churn, (n, S, S, 3))))
    tsampler = P.sampling_api.build_posterior_sampler(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), top,
        P.guidance.GuidanceConfig(**GCFG),
        P.sampling_api.SamplerConfig(**scfg), image_size=S, device="cpu")
    out_t, info_t = tsampler(P.operators.Measurement(y=nchw(y)), n=n,
                             init_noise=init, noise_fn=churn.__getitem__,
                             return_info=True)
    assert out_t.shape == (n, 3, S, S) and torch.isfinite(out_t).all()
    assert np.abs(nhwc(out_t) - np.asarray(out_j)).max() <= TOL
    assert 0 < info_t["cg_max_residual"] <= 1e-4
    assert 0 < float(info_j["cg_max_residual"]) <= 1e-4
    assert info_t["cg_total_iters"] > 0
