"""The Euler and DPM-Solver++(2M) samplers of `kdip_tpu_torch` against
`kdip_tpu`'s: with an analytic denoiser, and with a guided one through
`sampling_api.build_posterior_sampler(SamplerConfig(sampler=...))`, the
draws replayed from `kdip_tpu`'s key splits (samplers.py:88,
sampling_api.py:133-135)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import diffusion as jd
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu import samplers as js
from kdip_tpu import sampling_api as jsa
from kdip_tpu import schedules as jsch
from kdip_tpu.models import adm as jadm
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params

S = SMALL_UNET["image_size"]
STEPS, N = 4, 2
CHURN = dict(s_churn=80.0, s_tmin=0.05, s_tmax=50.0, s_noise=1.003)


def analytic(x, sigma):
    """The exact posterior mean x / (1 + sigma^2) of N(0, I) data."""
    return x / (1 + sigma ** 2)


def euler_churn_draws(key, shape, steps):
    """The churn noise kdip_tpu's Euler sampler draws from `key`, one per
    step (samplers.py:88-89), as NCHW tensors."""
    out = []
    for _ in range(steps):
        key, k_churn, _ = jax.random.split(key, 3)
        out.append(nchw(jax.random.normal(k_churn, shape)))
    return out


@pytest.mark.parametrize("sampler,churn", [("euler", False),
                                           ("euler", True),
                                           ("dpmpp_2m", False)])
def test_analytic_trajectory_matches(sampler, churn):
    """8 steps from sigma_max 80 with the analytic denoiser, the initial x
    and the churn noise shared: the port's samples within 1e-5 of
    kdip_tpu's, relative to their largest (float32 host scalars against
    float32 device scalars, in the same order)."""
    steps = 8
    sig_j = jsch.get_sigmas_karras(steps, 0.01, 80.0)
    sig_t = P.schedules.get_sigmas_karras(steps, 0.01, 80.0)
    rng = np.random.RandomState(0)
    x = (80.0 * rng.standard_normal((2, 4, 4, 3))).astype(np.float32)
    key = jax.random.key(3)
    kw = CHURN if churn else {}
    jden = lambda x, s, k: analytic(x, s)  # noqa: E731
    if sampler == "euler":
        want = js.sample_euler(jden, jnp.asarray(x), sig_j, key, **kw)
        got = P.samplers.sample_euler(
            analytic, nchw(x), sig_t,
            noise_fn=euler_churn_draws(key, x.shape, steps).__getitem__, **kw)
    else:
        want = js.sample_dpmpp_2m(jden, jnp.asarray(x), sig_j, key)
        got = P.samplers.sample_dpmpp_2m(analytic, nchw(x), sig_t)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(nhwc(got) / scale, want / scale, atol=1e-5)


@pytest.mark.parametrize("sampler,steps,atol", [("euler", 50, 2.5e-1),
                                                ("dpmpp_2m", 50, 2.5e-2)])
def test_ode_reaches_the_analytic_answer(sampler, steps, atol):
    """The ODE from sigma_max 80 to 0 with the analytic denoiser ends at
    x_init sqrt(1 + 0.01^2) / sqrt(1 + 80^2) (the verify recipe's check),
    up to the method's error at 50 steps on entries up to 3.9 (measured:
    Euler 0.187, first order; DPM++(2M) 0.0171, second order, Heun's
    0.0165)."""
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(2, 3, 8, 8, generator=g)
    sig = P.schedules.get_sigmas_karras(steps, 0.01, 80.0)
    fn = P.sampling_api.SAMPLERS[sampler]
    out = fn(analytic, x0 * 80.0, sig)
    want = x0 / np.sqrt(1 + 80.0 ** 2) * np.sqrt(1 + 0.01 ** 2) * 80.0
    assert torch.isfinite(out).all()
    assert (out - want).abs().max() <= atol


def _guided(sampler, gcfg, scfg, seed=5):
    """(kdip_tpu's samples and info, the port's) of Type-I guidance on
    inpainting through build_posterior_sampler with `sampler`, 2 samples
    against one measurement, the draws replayed from kdip_tpu's key."""
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=seed)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    op_cfg = dict(sigma_s=0.05, mask_opt=dict(
        mask_type="random", mask_prob_range=(0.5, 0.5), image_size=S))
    jop = jo.get_operator("inpainting", seed=1, **op_cfg)
    top = P.operators.get_operator("inpainting", seed=1, device="cpu",
                                   **op_cfg)
    rng = np.random.RandomState(2)
    x0 = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    y = (x0 + 0.05 * rng.standard_normal(x0.shape).astype(np.float32)
         ) * np.asarray(jop.mask)
    scfg = dict(scfg, sampler=sampler)
    jsampler = jsa.build_posterior_sampler(
        lambda p, x, t: jm.apply({"params": p}, x, jnp.asarray(t, jnp.float32)),
        jd.make_diffusion(1000, "linear"), jop,
        jg.GuidanceConfig(**gcfg, cg_warn=False), jsa.SamplerConfig(**scfg),
        image_size=S)
    key = jax.random.key(9)
    out_j, info_j = jax.jit(
        lambda p, m, k: jsampler(p, m, k, n=N, return_info=True))(
            params, jo.Measurement(y=jnp.asarray(y)), key)
    k_init, k_samp = jax.random.split(key)
    init = nchw(jax.random.normal(k_init, (N, S, S, 3)))
    churn = euler_churn_draws(k_samp, (N, S, S, 3), scfg["steps"])
    tsampler = P.sampling_api.build_posterior_sampler(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), top,
        P.guidance.GuidanceConfig(**gcfg), P.sampling_api.SamplerConfig(**scfg),
        image_size=S, device="cpu")
    out_t, info_t = tsampler(P.operators.Measurement(y=nchw(y)), n=N,
                             init_noise=init, noise_fn=churn.__getitem__,
                             return_info=True)
    return out_j, info_j, out_t, info_t


@pytest.mark.parametrize("sampler,ode", [("euler", False), ("euler", True),
                                         ("dpmpp_2m", False)])
def test_guided_trajectory_matches(sampler, ode):
    """Type-I Convert on inpainting, 4 steps from sigma_max 2 (the calls
    fall each side of the 0.2 threshold: the closed form, then CG), 2
    samples: final samples within 2e-3 (float32 on both sides, carried
    through 4 guided calls; sigma_max 2 keeps hat_x0's sigma^2
    cancellation small, as tests/test_torch_sampling.py explains), the
    worst CG residual below cg_tol in both. dpmpp_2m takes no churn, nor
    does --ode."""
    out_j, info_j, out_t, info_t = _guided(
        sampler, dict(guidance="I", x0_cov_type="convert"),
        dict(steps=STEPS, sigma_max=2.0, ode=ode))
    assert out_t.shape == (N, 3, S, S) and torch.isfinite(out_t).all()
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=2e-3)
    assert 0 < info_t["cg_max_residual"] <= 1e-4
    assert 0 < float(info_j["cg_max_residual"]) <= 1e-4
    assert info_t["cg_total_iters"] > 0


def test_sampler_config_is_checked():
    """An unknown sampler is refused; so is the warm start with dpmpp_2m,
    which carries no solver state (kdip_tpu asserts the same,
    sampling_api.py:82-85)."""
    top = P.operators.get_operator("noise", device="cpu")
    tab = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    G, C = P.guidance.GuidanceConfig, P.sampling_api.SamplerConfig
    with pytest.raises(ValueError, match="unknown sampler"):
        P.sampling_api.build_posterior_sampler(None, tab, top, G(),
                                               C(sampler="lms"))
    with pytest.raises(ValueError, match="dpmpp_2m"):
        P.sampling_api.build_posterior_sampler(
            None, tab, top, G(cg_warm_start=True), C(sampler="dpmpp_2m"))
    with pytest.raises(AssertionError):
        jsa.build_posterior_sampler(None, jd.make_diffusion(1000, "linear"),
                                    jo.get_operator("noise"),
                                    jg.GuidanceConfig(cg_warm_start=True),
                                    jsa.SamplerConfig(sampler="dpmpp_2m"))
