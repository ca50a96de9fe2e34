"""autoI guidance and the measurement log-likelihood of `kdip_tpu_torch`
(`autoi.py`, guidance.make_condition_denoiser's "autoI" and
`denoise.loglikelihood`) against `kdip_tpu`'s, with the same random
weights (moved through `weights.from_jax_params`), the same seeded numpy
inputs, NHWC against NCHW, and `kdip_tpu`'s Rademacher draws
(`fold_in(key, i)`) injected into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import autoi as jai
from kdip_tpu import diffusion as jd
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu import sampling_api as jsa
from kdip_tpu.models import adm as jadm
from kdip_tpu.ops import transforms as jtf
from test_torch_port import (SMALL_UNET, nchw, nhwc, one_torch_thread,  # noqa: F401
                             random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = SMALL_UNET["image_size"]
OPS = {
    # configs/inpainting_config.yaml at 16 px
    "inpainting": dict(sigma_s=0.05, mask_opt=dict(
        mask_type="random", mask_prob_range=(0.5, 0.5), image_size=S)),
    # configs/gaussian_deblur_config.yaml, its kernel cut to 9 px
    "gaussian_blur": dict(in_shape=(1, 3, S, S), kernel_size=9,
                          intensity=3.0, sigma_s=0.05),
}
PROBES = 2
# name: (operator, v2, guidance config), each at 0.3x and 3x its threshold
CASES = {
    "v1-convert-inpainting": ("inpainting", False, dict()),
    "v1-convert-deblur": ("gaussian_blur", False, dict()),
    "v2-dwt-inpainting": ("inpainting", True, dict(ortho_tf_type="dwt",
                                                   mle_sigma_thres=1.0)),
    "v2-dwt-deblur": ("gaussian_blur", True, dict(ortho_tf_type="dwt",
                                                  mle_sigma_thres=1.0)),
    "v2-dct-inpainting": ("inpainting", True, dict(ortho_tf_type="dct",
                                                   mle_sigma_thres=1.0)),
    "v2-dct-deblur": ("gaussian_blur", True, dict(ortho_tf_type="dct",
                                                  mle_sigma_thres=1.0)),
}
# the worst CG residuals of the 1 + PROBES solves: each below cg_tol on
# both sides and within this ratio of the other where it is above 1e-6 (a
# CG stops at the first iteration under tol, and rounding moves where that
# lands by up to one iteration's contraction; below 1e-6, after 3
# iterations above the threshold, what is left is float32 rounding:
# measured 1.4e-7 against 4.4e-8)
RESID_RATIO, RESID_FLOOR = 2.0, 1e-6


def _op_pair(op_name, seed=0):
    return (jo.get_operator(op_name, seed=seed, **OPS[op_name]),
            P.operators.get_operator(op_name, seed=seed, device="cpu",
                                     **OPS[op_name]))


def _measurement(jop, op_name, seed):
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    ax = np.asarray(jop.forward(jnp.asarray(x0)))
    y = (ax + 0.05 * rng.standard_normal(ax.shape)).astype(np.float32)
    return y * np.asarray(jop.mask) if op_name == "inpainting" else y


def build(op_name, v2, gcfg, seed=3):
    """(jax denoise, port denoise, jax autoI, port autoI) of one autoI
    configuration, with the same random weights, measurement and
    operator; the last two are autoi.auto_type_I_guidance's unclipped
    hat_x0 and residual, of (x, sigma, key) and (x, sigma, probes)."""
    unet = jadm.ADMUNet(**SMALL_UNET)
    jm = jadm.ADMUNetV2(unet=unet) if v2 else unet
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=seed)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    if v2:
        tm = P.adm.ADMUNetV2(tm)
    tm.load_state_dict(P.weights.from_jax_params(params))
    jop, top = _op_pair(op_name)
    y = _measurement(jop, op_name, seed)
    cfg = dict(guidance="autoI", num_probes=PROBES, **gcfg)
    jcfg = jg.GuidanceConfig(**cfg, cg_warn=False)
    tcfg = P.guidance.GuidanceConfig(**cfg)
    fwd = lambda p, x, t: jm.apply({"params": p}, x,  # noqa: E731
                                   jnp.asarray(t, jnp.float32))
    jtab = jd.make_diffusion(1000, "linear")
    ttab = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    if v2:
        ju, jv = jg.make_openai_v2_uncond(fwd, jtab, jcfg)
        tu, tv = P.guidance.make_openai_v2_uncond(tm, ttab, tcfg)
    else:
        ju, jv = jg.make_openai_uncond(fwd, jtab, jcfg)
        tu, tv = P.guidance.make_openai_uncond(tm, ttab, tcfg)
    jden = jg.make_condition_denoiser(
        ju, jv, jop, jo.Measurement(y=jnp.asarray(y)), jcfg, params=params,
        v2=v2, with_info=True)
    tden = P.guidance.make_condition_denoiser(
        tu, tv, top, P.operators.Measurement(y=nchw(y)), tcfg, v2=v2,
        with_info=True)
    jot = jtf.OrthoTransform(jcfg.ortho_tf_type)
    tot = P.ops.transforms.OrthoTransform(tcfg.ortho_tf_type)

    @jax.jit
    def jauto(x, sigma, key):
        return jai.auto_type_I_guidance(ju, jv, jop, jnp.asarray(y), jcfg,
                                        params, x, sigma, key, jot, v2=v2)

    def tauto(x, sigma, probes):
        return P.autoi.auto_type_I_guidance(tu, tv, top, nchw(y), tcfg, x,
                                            sigma, tot, probes, v2=v2)
    return jden, tden, jauto, tauto


def jax_probes(key, shape, n=PROBES):
    """kdip_tpu's autoI probes of one call, as NCHW tensors
    (autoi.py:188-189)."""
    return [nchw(jax.random.rademacher(jax.random.fold_in(key, i), shape,
                                       dtype=jnp.float32)) for i in range(n)]


def slq_probes(key, y_nhwc_shape, n=PROBES):
    """kdip_tpu's SLQ probes (flat, over NHWC y; autoi.py:94-95) in the
    port's NCHW order."""
    d = int(np.prod(y_nhwc_shape))
    return [nchw(np.asarray(jax.random.rademacher(
        jax.random.fold_in(key, i), (d,), dtype=jnp.float32)).reshape(
            y_nhwc_shape)) for i in range(n)]


@pytest.mark.parametrize("name", list(CASES))
def test_autoi_denoise_matches(name):
    """One autoI call at 0.3x and 3x the threshold, fed kdip_tpu's probes:
    the denoiser's hat_x0 within 1e-3 of kdip_tpu's (its
    auto_type_I_guidance, clipped), and the port's unclipped
    auto_type_I_guidance within 5e-5 of its largest entry (float32 in both, other
    summation orders through 1 + PROBES CG solves, the UNet's vjp and
    sigma^2; measured at most 1.1e-5, at 3x the threshold where hat_x0
    reaches 169); the worst CG residual below cg_tol on both sides and
    within RESID_RATIO. Above the threshold the port's K runs theta * u,
    kdip_tpu's W^-1(theta W u) on a constant theta (the same matrix), and
    the variance takes no cotangent: for the V2 heads other probes give
    the same hat_x0 there, and another below it."""
    op_name, v2, gcfg = CASES[name]
    _, tden, jauto, tauto = build(op_name, v2, gcfg)
    thres = gcfg.get("mle_sigma_thres", 0.2)
    rng = np.random.RandomState(11)
    xs = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    for i, sigma in enumerate((0.3 * thres, 3.0 * thres)):
        key = jax.random.key(20 + i)
        x = xs + sigma * rng.standard_normal(xs.shape).astype(np.float32)
        probes = jax_probes(key, x.shape)
        # kdip_tpu's autoI denoiser is this, clipped (guidance.py:744, 810)
        hat_j, r_j = jauto(jnp.asarray(x), jnp.float32(sigma), key)
        hat_j, r_j = np.asarray(hat_j), float(r_j)
        out_t, info_t = tden(nchw(x), sigma, probes=probes)
        np.testing.assert_allclose(nhwc(out_t), np.clip(hat_j, -1, 1),
                                   atol=1e-3, err_msg=f"sigma {sigma}")
        hat_t, r_t, iters = tauto(nchw(x), sigma, probes)
        scale = np.abs(hat_j).max()
        np.testing.assert_allclose(nhwc(hat_t) / scale, hat_j / scale,
                                   atol=5e-5, err_msg=f"sigma {sigma}")
        assert r_t == info_t["cg_resid"] and iters == info_t["cg_iters"]
        assert 0 < r_t <= 1e-4 and 0 < r_j <= 1e-4, (r_t, r_j)
        assert max(r_t, r_j) <= RESID_RATIO * max(min(r_t, r_j), RESID_FLOOR)
        assert iters >= 1 + PROBES
        if v2:
            other = tauto(nchw(x), sigma,
                          jax_probes(jax.random.key(99), x.shape))[0]
            if sigma > thres:
                assert torch.equal(other, hat_t)
            else:
                assert (other - hat_t).abs().max() > 1e-3


@pytest.mark.parametrize("op_name", ["inpainting", "gaussian_blur"])
@pytest.mark.parametrize("ortho", [None, "dwt", "dct"])
def test_measurement_matvec_for_any_u(op_name, ortho):
    """K(u) = s2 u + A(W diag(v) W^T A^T u) for a u outside the mask's
    range, against kdip_tpu's composition (autoi.py:134, 176-177), within
    2e-6 of its largest entry. For inpainting in the DWT or DCT basis the
    inpainting solve's fused matvec, which has no inner mask, gives
    another answer on such a u: SLQ's Lanczos vectors start from
    full-image probes."""
    jop, top = _op_pair(op_name)
    rng = np.random.RandomState(5)
    u = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    v = rng.uniform(0.05, 1.0, (1, S, S, 3)).astype(np.float32)
    ot = jtf.OrthoTransform(ortho)
    s2 = jnp.clip(jop.sigma_s, min=0.001) ** 2
    want = np.asarray(s2 * jnp.asarray(u) + jop.forward(ot.inv(
        jnp.asarray(v) * ot(jop.transpose(jnp.asarray(u))))))
    tot = P.ops.transforms.OrthoTransform(ortho)
    K = P.autoi.measurement_matvec(top, tot, nchw(v))
    got = nhwc(K(nchw(u)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)
    if op_name == "inpainting" and ortho is not None:
        fused = nhwc(tot.masked_cov_matvec(
            nchw(u), nchw(v), top.mask, P.guidance._sigma_s2(top, 0.001)))
        assert np.abs(fused - want).max() > 1e-2 * scale
    # a host-float variance: theta * u, the same matrix as W^-1(theta W u)
    theta = np.float32(0.37)
    want = np.asarray(s2 * jnp.asarray(u) + jop.forward(ot.inv(
        theta * ot(jop.transpose(jnp.asarray(u))))))
    got = nhwc(P.autoi.measurement_matvec(top, tot, float(theta))(nchw(u)))
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


def test_slq_logdet_matches():
    """slq_logdet on a 64 x 64 SPD matrix, fed kdip_tpu's probes: within
    1e-4 relative of kdip_tpu's estimate (float32 Lanczos with full
    reorthogonalisation, then eigh of a 12 x 12 tridiagonal); and exact on
    c I (every probe integrates d log c)."""
    d = 64
    B = np.random.RandomState(7).standard_normal((d, d)).astype(np.float32)
    K = (B @ B.T / d + 0.5 * np.eye(d)).astype(np.float32)
    key = jax.random.key(1)
    want = float(jai.slq_logdet(lambda u: jnp.asarray(K) @ u, jnp.zeros(d),
                                key, num_probes=6, lanczos_iters=12))
    probes = [torch.from_numpy(np.array(jax.random.rademacher(
        jax.random.fold_in(key, i), (d,), dtype=jnp.float32)))
        for i in range(6)]
    Kt = torch.from_numpy(K)
    got = float(P.autoi.slq_logdet(lambda u: Kt @ u, torch.zeros(d),
                                   probes=probes, lanczos_iters=12))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    exact = float(np.linalg.slogdet(K.astype(np.float64))[1])
    assert abs(got - exact) <= 0.1 * abs(exact)
    c = 3.7
    got = float(P.autoi.slq_logdet(
        lambda u: c * u, torch.zeros(4, 5),
        generator=torch.Generator().manual_seed(0), num_probes=2,
        lanczos_iters=4))
    np.testing.assert_allclose(got, 20 * np.log(c), rtol=1e-5)


@pytest.mark.parametrize("name", ["v1-convert-inpainting",
                                  "v2-dwt-inpainting", "v2-dwt-deblur"])
def test_loglikelihood_matches(name):
    """denoise.loglikelihood at 0.3x the threshold (a tensor variance) and
    at 3x (mle_var), fed kdip_tpu's SLQ probes: within 5e-5 d of
    kdip_tpu's value, and both CG residuals below cg_tol. The value sums
    three float32 terms of size ~d (the quadratic term, the logdet, d log
    2 pi) that may cancel to far less, so the tolerance scales with d = 768
    (measured: at most 7.4e-3 = 9.6e-6 d, where the value is 100.3)."""
    op_name, v2, gcfg = CASES[name]
    jden, tden, _, _ = build(op_name, v2, gcfg)
    thres = gcfg.get("mle_sigma_thres", 0.2)
    rng = np.random.RandomState(13)
    xs = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    for i, sigma in enumerate((0.3 * thres, 3.0 * thres)):
        key = jax.random.key(30 + i)
        x = xs + sigma * rng.standard_normal(xs.shape).astype(np.float32)
        ll_j, r_j = jax.jit(jden.loglikelihood)(jnp.asarray(x),
                                                jnp.float32(sigma), key)
        ll_t, r_t = tden.loglikelihood(nchw(x), sigma,
                                       probes=slq_probes(key, x.shape))
        ll_j, ll_t = float(ll_j), float(ll_t)
        assert np.isfinite(ll_t) and r_t <= 1e-4 and float(r_j) <= 1e-4
        assert abs(ll_t - ll_j) <= 5e-5 * x.size, (sigma, ll_t, ll_j)


def test_loglikelihood_on_every_denoiser():
    """Every denoiser carries loglikelihood (kdip_tpu guidance.py:804,
    814, 826): Type-I, an +mle mode, and the warm-start denoiser, each
    finite, from probes drawn from the generator."""
    jop, top = _op_pair("inpainting")
    y = P.operators.Measurement(y=nchw(_measurement(jop, "inpainting", 3)))
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    ttab = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (1, 3, S, S)).astype(np.float32))
    for cfg in (P.guidance.GuidanceConfig("I"),
                P.guidance.GuidanceConfig("dps+mle", zeta=1.0),
                P.guidance.GuidanceConfig("I", cg_warm_start=True)):
        tu, tv = P.guidance.make_openai_uncond(tm, ttab, cfg)
        den = P.guidance.make_condition_denoiser(
            tu, tv, top, y, cfg, with_info=True,
            generator=torch.Generator().manual_seed(0))
        ll, resid = den.loglikelihood(x, 0.1)
        assert ll.shape == () and torch.isfinite(ll) and resid <= 1e-4


def test_autoi_with_tmpd_raises_in_both():
    """kdip_tpu's autoI hands x0_var_fn no vjp (autoi.py:164), so tmpd's
    variance fails its assert (guidance.py:187) when the denoiser is
    traced, whatever the model (here x0_mean = x); the port refuses the
    configuration when the denoiser is built."""
    jop, top = _op_pair("inpainting")
    y = _measurement(jop, "inpainting", 3)
    cfg = jg.GuidanceConfig("autoI", "tmpd", num_probes=1)
    _, jv = jg.make_openai_uncond(None, jd.make_diffusion(1000, "linear"),
                                  cfg)
    jden = jg.make_condition_denoiser(
        lambda p, x, sigma: (x, {}), jv, jop,
        jo.Measurement(y=jnp.asarray(y)), cfg)
    with pytest.raises(AssertionError):
        jden(jnp.zeros((1, S, S, 3)), jnp.float32(0.5), jax.random.key(0))
    with pytest.raises(ValueError, match="tmpd"):
        P.guidance.make_condition_denoiser(
            None, None, top, P.operators.Measurement(y=nchw(y)),
            P.guidance.GuidanceConfig("autoI", "tmpd"))


def test_autoi_draws_from_the_generator():
    """Without injected probes autoI draws cfg.num_probes Rademacher
    tensors from the generator: the same seed gives the same hat_x0,
    another seed another; a wrong probe count is refused."""
    _, tden, _, _ = build("inpainting", True, CASES["v2-dwt-inpainting"][2])
    x = nchw(np.random.RandomState(2).uniform(-1, 1, (1, S, S, 3))
             .astype(np.float32))
    r = P.autoi.rademacher((4, 5), torch.Generator().manual_seed(0))
    assert set(r.unique().tolist()) == {-1.0, 1.0}
    outs = []
    for seed in (0, 0, 1):
        gen = torch.Generator().manual_seed(seed)
        probes = [P.autoi.rademacher(x.shape, gen) for _ in range(PROBES)]
        outs.append(tden(x, 0.3, probes=probes)[0])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="num_probes"):
        tden(x, 0.3, probes=probes[:1])


# ---------------------------------------------------------------------------
# a trajectory through build_posterior_sampler
# ---------------------------------------------------------------------------

STEPS, N = 3, 2


def test_autoi_trajectory_matches():
    """autoI with the DWT-Var head on inpainting through the sampler: Heun,
    3 steps with churn, 2 samples against one measurement (the per-sample
    loop), sigma_max 2 (so the calls fall each side of the 1.0 threshold),
    the initial x, the churn noise and every call's probes replayed from
    kdip_tpu's key (samplers.py:137-138; lax.map gives every sample of a
    call one key, so one probe set): final samples within 2e-3 (float32
    in both, carried through 5 guided calls), the worst CG residual below
    cg_tol in both."""
    gcfg = dict(guidance="autoI", ortho_tf_type="dwt", mle_sigma_thres=1.0,
                num_probes=PROBES)
    scfg = dict(steps=STEPS, sigma_max=2.0)
    jm = jadm.ADMUNetV2(unet=jadm.ADMUNet(**SMALL_UNET))
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=5)
    tm = P.adm.ADMUNetV2(P.adm.ADMUNet(**SMALL_UNET, device="cpu"))
    tm.load_state_dict(P.weights.from_jax_params(params))
    jop, top = _op_pair("inpainting", seed=1)
    y = _measurement(jop, "inpainting", 2)
    jsampler = jsa.build_posterior_sampler(
        lambda p, x, t: jm.apply({"params": p}, x, jnp.asarray(t, jnp.float32)),
        jd.make_diffusion(1000, "linear"), jop,
        jg.GuidanceConfig(**gcfg, cg_warn=False), jsa.SamplerConfig(**scfg),
        v2=True, image_size=S)
    key = jax.random.key(9)
    out_j, info_j = jax.jit(
        lambda p, m, k: jsampler(p, m, k, n=N, return_info=True))(
            params, jo.Measurement(y=jnp.asarray(y)), key)

    k_init, k = jax.random.split(key)
    init = nchw(jax.random.normal(k_init, (N, S, S, 3)))
    churn, probes = [], []
    for step in range(STEPS):
        k, k_churn, k_m, k_m2 = jax.random.split(k, 4)
        churn.append(nchw(jax.random.normal(k_churn, (N, S, S, 3))))
        for km in ((k_m,) if step == STEPS - 1 else (k_m, k_m2)):
            probes.append(jax_probes(km, (1, S, S, 3)))
    tsampler = P.sampling_api.build_posterior_sampler(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), top,
        P.guidance.GuidanceConfig(**gcfg), P.sampling_api.SamplerConfig(**scfg),
        v2=True, image_size=S, device="cpu")
    out_t, info_t = tsampler(P.operators.Measurement(y=nchw(y)), n=N,
                             init_noise=init, noise_fn=churn.__getitem__,
                             probe_fn=probes.__getitem__, return_info=True)
    assert out_t.shape == (N, 3, S, S) and torch.isfinite(out_t).all()
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=2e-3)
    assert 0 < info_t["cg_max_residual"] <= 1e-4
    assert 0 < float(info_j["cg_max_residual"]) <= 1e-4
    assert info_t["cg_total_iters"] > 0
