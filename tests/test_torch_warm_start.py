"""The CG warm start of `kdip_tpu_torch` (GuidanceConfig.cg_warm_start:
each likelihood solve of guidance I/II starts from the previous sampler
step's CG iterate), tests/test_cg_warm_start.py's cases mirrored and held
against `kdip_tpu`: the CG's x0, warm against cold, the iteration totals,
the per-sample states, the misuse checks and init_solver_state's shapes.

The configuration is Type-I Convert on gaussian deblur with the mle
threshold at 100, so every call of a short trajectory runs a CG; its
variance is clipped at 1e-6, so the system is positive definite and every
solve converges (tmpd with random weights need not, see
tests/test_torch_guidance_modes.py)."""

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
OP = dict(in_shape=(1, 3, S, S), kernel_size=7, intensity=1.5, sigma_s=0.05)
GCFG = dict(guidance="I", x0_cov_type="convert", mle_sigma_thres=100.0)


def _diag():
    return np.linspace(0.5, 4.0, 64).astype(np.float32)


def test_cg_accepts_x0_in_both():
    """Started at its own solution, CG runs no iteration in either package
    and returns the seed; from 0 both run the same number of iterations."""
    d = _diag()
    cfg_j = jg.GuidanceConfig(cg_tol=1e-5)
    cfg_t = P.guidance.GuidanceConfig(cg_tol=1e-5)
    mv_j = lambda v: jnp.asarray(d) * v  # noqa: E731
    dt = torch.from_numpy(d)
    x_j, _, k_j = jg._cg(mv_j, jnp.ones(64), cfg_j, want_iters=True)
    x_t, r_t, k_t = P.guidance._cg(lambda v: dt * v, torch.ones(64), cfg_t)
    assert k_t == int(k_j) > 0 and r_t <= 1e-5
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-5)
    _, _, k_j = jg._cg(mv_j, jnp.ones(64), cfg_j, x0=x_j, want_iters=True)
    x2, _, k2 = P.guidance._cg(lambda v: dt * v, torch.ones(64), cfg_t,
                               x0=x_t)
    assert int(k_j) == 0 and k2 == 0 and torch.equal(x2, x_t)


def test_zero_rhs_with_a_seed_burns_the_budget_in_both():
    """A fault ported as it is (ADVICE.md, guidance.py:286): with b = 0 the
    tolerance tol |b| is 0, so a nonzero seed never converges and the
    solve runs its whole budget, in both packages."""
    d = _diag()
    seed = np.ones(64, np.float32)
    _, r_j, k_j = jg._cg(lambda v: jnp.asarray(d) * v, jnp.zeros(64),
                         jg.GuidanceConfig(cg_maxiter=7, cg_warn=False),
                         x0=jnp.asarray(seed), want_iters=True)
    dt = torch.from_numpy(d)
    with pytest.warns(RuntimeWarning, match="CG did not converge in 7"):
        _, r_t, k_t = P.guidance._cg(
            lambda v: dt * v, torch.zeros(64),
            P.guidance.GuidanceConfig(cg_maxiter=7), x0=torch.from_numpy(seed))
    assert k_t == int(k_j) == 7


def _setup(seed=5):
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=seed)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    fwd = lambda p, x, t: jm.apply({"params": p}, x,  # noqa: E731
                                   jnp.asarray(t, jnp.float32))
    jop = jo.get_operator("gaussian_blur", seed=0, **OP)
    top = P.operators.get_operator("gaussian_blur", seed=0, device="cpu", **OP)
    rng = np.random.RandomState(2)
    x0 = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    ax = np.asarray(jop.forward(jnp.asarray(x0)))
    y = (ax + 0.05 * rng.standard_normal(ax.shape)).astype(np.float32)
    return fwd, params, tm, jop, top, y


def _samplers(gcfg, scfg, n, setup, jax_side=True):
    """(samples and info of kdip_tpu, of the port) through
    build_posterior_sampler, Heun with churn, the draws replayed from
    kdip_tpu's key (samplers.py:137-138); kdip_tpu's are None without
    `jax_side`."""
    fwd, params, tm, jop, top, y = setup
    key = jax.random.key(9)
    out_j = info_j = None
    if jax_side:
        jsampler = jsa.build_posterior_sampler(
            fwd, jd.make_diffusion(1000, "linear"), jop,
            jg.GuidanceConfig(**gcfg, cg_warn=False),
            jsa.SamplerConfig(**scfg), image_size=S)
        out_j, info_j = jax.jit(
            lambda p, m, k: jsampler(p, m, k, n=n, return_info=True))(
                params, jo.Measurement(y=jnp.asarray(y)), key)
    k_init, k = jax.random.split(key)
    init = nchw(jax.random.normal(k_init, (n, S, S, 3)))
    churn = []
    for _ in range(scfg["steps"]):
        k, k_churn, _, _ = jax.random.split(k, 4)
        churn.append(nchw(jax.random.normal(k_churn, (n, S, S, 3))))
    tsampler = P.sampling_api.build_posterior_sampler(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), top,
        P.guidance.GuidanceConfig(**gcfg), P.sampling_api.SamplerConfig(**scfg),
        image_size=S, device="cpu")
    out_t, info_t = tsampler(P.operators.Measurement(y=nchw(y)), n=n,
                             init_noise=init, noise_fn=churn.__getitem__,
                             return_info=True)
    return out_j, info_j, out_t, info_t


@pytest.mark.parametrize("n", [1, 2])
def test_warm_trajectory_matches_kdip_tpu_and_the_cold_one(n):
    """Heun, 3 steps from sigma_max 0.5, n samples against one measurement
    (n = 2: the per-sample loop, one solver state per sample): the warm
    samples within 2e-3 of kdip_tpu's warm ones and of the port's cold
    ones (every solve stops at the same tol |b|; float32, carried through
    5 guided calls; measured 1.1e-4 at n = 1, 2.3e-4 at n = 3); every
    solve converged; the total CG iterations within 2 per solve of
    kdip_tpu's (measured: equal). Higher
    up, each call's CG error tol |b| reaches hat_x0 through sigma^2 times
    the vjp: from sigma_max 2 one call differs by 2.5e-3 at sigma 2.5, and
    5 calls carry it to 0.45, cold or warm alike."""
    setup = _setup()
    scfg = dict(steps=3, sigma_max=0.5)
    out_j, info_j, out_t, info_t = _samplers(
        dict(GCFG, cg_warm_start=True), scfg, n, setup)
    solves = n * (2 * scfg["steps"] - 1)
    assert out_t.shape == (n, 3, S, S) and torch.isfinite(out_t).all()
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=2e-3)
    assert 0 < info_t["cg_max_residual"] <= 1e-4
    assert 0 < float(info_j["cg_max_residual"]) <= 1e-4
    it_t, it_j = info_t["cg_total_iters"], int(info_j["cg_total_iters"])
    assert abs(it_t - it_j) <= 2 * solves, (it_t, it_j)
    cold = _samplers(GCFG, scfg, n, setup, jax_side=False)[2]
    np.testing.assert_allclose(nhwc(out_t), nhwc(cold), atol=2e-3)


def test_warm_start_saves_iterations():
    """Replayed over the same (x, sigma) calls, a warm solve never runs
    more than 2 iterations beyond the cold one, the first call has nothing
    to warm, and the total drops (test_cg_warm_start.py's check)."""
    fwd, params, tm, jop, top, y = _setup()
    cfg = P.guidance.GuidanceConfig(**GCFG, cg_warm_start=True)
    tu, tv = P.guidance.make_openai_uncond(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), cfg)
    den = P.guidance.make_condition_denoiser(
        tu, tv, top, P.operators.Measurement(y=nchw(y)), cfg, with_info=True)
    st0 = P.guidance.init_solver_state(top, (1, 3, S, S))
    sigmas = P.schedules.get_sigmas_karras(6, 1e-2, 0.5).tolist()
    x = torch.randn(1, 3, S, S, generator=torch.Generator().manual_seed(9)
                    ) * 0.5
    calls, cold = [], []
    for i in range(6):
        calls.append((x, sigmas[i]))
        out, info = den(x, sigmas[i], solver_state=st0)
        cold.append(info["cg_iters"])
        x = x + (x - out) / sigmas[i] * (sigmas[i + 1] - sigmas[i])
    st, warm = st0, []
    for x_i, s_i in calls:
        _, info = den(x_i, s_i, solver_state=st)
        st = info["solver_state"]
        assert st["iters"] == info["cg_iters"]
        warm.append(info["cg_iters"])
    assert warm[0] == cold[0] > 0
    assert all(w <= c + 2 for w, c in zip(warm, cold)), (warm, cold)
    assert sum(warm) < sum(cold), (warm, cold)


def test_warm_start_misuse_is_refused():
    """kdip_tpu's asserts (guidance.py:789-795) as ValueErrors: a
    closed-form covariance, a mode without a CG solve, a denoiser without
    info; and the warm denoiser refuses a call without a state."""
    op = P.operators.get_operator("gaussian_blur", device="cpu", **OP)
    meas = P.operators.Measurement(y=torch.zeros(1, 3, S, S))
    jop = jo.get_operator("gaussian_blur", **OP)
    jmeas = jo.Measurement(y=jnp.zeros((1, S, S, 3)))
    G, J = P.guidance.GuidanceConfig, jg.GuidanceConfig
    for kw, match in ((dict(guidance="I", x0_cov_type="pgdm"), "closed"),
                      (dict(guidance="dps", zeta=1.0), "I/II")):
        with pytest.raises(AssertionError):
            jg.make_condition_denoiser(lambda *a: None, lambda *a: None, jop,
                                       jmeas, J(**kw, cg_warm_start=True),
                                       with_info=True)
        with pytest.raises(ValueError, match=match):
            P.guidance.make_condition_denoiser(
                None, None, op, meas, G(**kw, cg_warm_start=True),
                with_info=True)
    with pytest.raises(ValueError, match="with_info"):
        P.guidance.make_condition_denoiser(None, None, op, meas,
                                           G(cg_warm_start=True))
    den = P.guidance.make_condition_denoiser(None, None, op, meas,
                                             G(cg_warm_start=True),
                                             with_info=True)
    with pytest.raises(ValueError, match="solver_state"):
        den(torch.zeros(1, 3, S, S), 0.5)


@pytest.mark.parametrize("name,kw,want", [
    ("super_resolution", dict(in_shape=(1, 3, 32, 32), scale_factor=4),
     (2, 3, 8, 8)),
    ("colorization", {}, (2, 1, 32, 32)),
    ("inpainting", dict(mask_opt=dict(mask_type="random",
                                      mask_prob_range=(0.5, 0.5),
                                      image_size=32)), (2, 3, 32, 32)),
])
def test_solver_state_shapes(name, kw, want):
    """init_solver_state's u, NCHW: low-resolution for super-resolution,
    one channel for colorization, x's shape otherwise, as kdip_tpu's
    (NHWC) is; iters 0."""
    top = P.operators.get_operator(name, sigma_s=0.05, device="cpu", **kw)
    st = P.guidance.init_solver_state(top, (2, 3, 32, 32))
    assert tuple(st["u"].shape) == want and st["iters"] == 0
    assert not st["u"].any()
    jst = jg.init_solver_state(jo.get_operator(name, sigma_s=0.05, **kw),
                               (2, 32, 32, 3))
    assert jst["u"].shape == (want[0], want[2], want[3], want[1])
