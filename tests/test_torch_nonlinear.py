"""The nonlinear operators (phase retrieval, nonlinear blur) and the poisson
noise of `kdip_tpu_torch.operators` against `kdip_tpu`'s, and dps / stsl
guidance through them (the guidance modes that reach an operator without
a mat solver, tests/test_nonlinear_guidance.py), with the same seeded
numpy inputs, NHWC against NCHW, and `kdip_tpu`'s draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kdip_tpu_torch as P
from kdip_tpu import diffusion as jd
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu import samplers as js
from kdip_tpu import schedules as jsch
from kdip_tpu.models import adm as jadm
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params

S = SMALL_UNET["image_size"]
PAD = 4                     # oversample 0.125: int(0.125 / 8 * 256)
# the nonlinear blur's kernel: kdip_tpu's NHWC (1, 2, 2, 4), the port's
# NCHW (1, 4, 2, 2)
KSHAPE_J, KSHAPE_T = (1, 2, 2, 4), (1, 4, 2, 2)
_W = (0.3 * np.random.RandomState(17).standard_normal((3, 3, 3, 3))
      ).astype(np.float32)            # HWIO


def blur_jax(x01, kernel):
    """A small differentiable blur network over NHWC [0, 1] images: a 3x3
    conv whose gain the kernel sets, then a sigmoid (a stand-in for the
    external KernelWizard)."""
    y = jax.lax.conv_general_dilated(x01, jnp.asarray(_W), (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO",
                                                        "NHWC"))
    return jax.nn.sigmoid(y * (1 + 0.1 * jnp.tanh(kernel).mean()))


def blur_torch(x01, kernel):
    """blur_jax's twin over NCHW images."""
    w = torch.from_numpy(np.ascontiguousarray(_W.transpose(3, 2, 0, 1)))
    y = F.conv2d(x01, w, padding=1)
    return torch.sigmoid(y * (1 + 0.1 * torch.tanh(kernel).mean()))


def _image(seed, batch=1):
    return np.random.RandomState(seed).uniform(
        -1, 1, (batch, S, S, 3)).astype(np.float32)


def _blur_ops():
    """(kdip_tpu's, the port's) nonlinear blur, the port's kernel that of
    kdip_tpu's keyless forward (key(0), operators.py:417-418)."""
    jop = jo.get_operator("nonlinear_blur", blur_apply=blur_jax,
                          kernel_shape=KSHAPE_J, sigma_s=0.05)
    kernel = jax.random.normal(jax.random.key(0), KSHAPE_J) * 1.2
    top = P.operators.get_operator(
        "nonlinear_blur", blur_apply=blur_torch, kernel_shape=KSHAPE_T,
        kernel=nchw(kernel), sigma_s=0.05, device="cpu")
    return jop, top


def test_phase_retrieval_forward_and_vjp():
    """|F(pad(x))| within 1e-5 of its largest entry, and its vjp at a random
    cotangent within 1e-5 of the largest (both float32 FFTs); get_operator's
    pad is oversample / 8 of 256 (32 at oversample 1.0, 320 px FFTs at 256
    px); measure adds sigma_s times the injected noise; project as
    kdip_tpu's."""
    jop = jo.PhaseRetrievalOperator(pad=PAD, sigma_s=jnp.float32(0.05))
    top = P.operators.get_operator("phase_retrieval", oversample=0.125,
                                   device="cpu")
    assert top.pad == PAD and top.name == "phase_retrieval"
    assert P.operators.get_operator("phase_retrieval").pad == 32
    x = _image(0, batch=2)
    want, vjp = jax.vjp(jop.forward, jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    got = top.forward(xt)
    assert got.shape == (2, 3, S + 2 * PAD, S + 2 * PAD)
    scale = float(jnp.abs(want).max())
    np.testing.assert_allclose(nhwc(got) / scale, np.asarray(want) / scale,
                               atol=1e-5)
    ct = np.random.RandomState(1).standard_normal(want.shape).astype(
        np.float32)
    g_want = np.asarray(vjp(jnp.asarray(ct))[0])
    g_got, = torch.autograd.grad(got, xt, nchw(ct))
    scale = np.abs(g_want).max()
    np.testing.assert_allclose(nhwc(g_got) / scale, g_want / scale, atol=1e-5)
    noise = np.random.RandomState(2).standard_normal(want.shape).astype(
        np.float32)
    y = top.measure(nchw(x), noise=nchw(noise)).y
    np.testing.assert_allclose(nhwc(y), np.asarray(want) + 0.05 * noise,
                               atol=1e-5 * float(jnp.abs(want).max()))
    # project (x + y - A x) needs y of x's shape: pad 0
    j0 = jo.PhaseRetrievalOperator(pad=0, sigma_s=jnp.float32(0.05))
    t0 = P.operators.PhaseRetrievalOperator(pad=0, sigma_s=0.05)
    y0 = _image(3, batch=2)
    want = np.asarray(j0.project(jnp.asarray(x), jnp.asarray(y0)))
    np.testing.assert_allclose(nhwc(t0.project(nchw(x), nchw(y0))), want,
                               atol=1e-5 * np.abs(want).max())


def test_nonlinear_blur_forward_and_measure():
    """The operator around twin callables: forward with the default
    kernel within 1e-6 (the [-1, 1] <-> [0, 1] rescaling and the clip are
    the same float32 steps), and differentiable; measure with kdip_tpu's
    kernel draw (k1) and noise (k2) injected; without a callable both
    packages refuse to build it."""
    jop, top = _blur_ops()
    x = _image(3)
    np.testing.assert_allclose(nhwc(top.forward(nchw(x))),
                               np.asarray(jop.forward(jnp.asarray(x))),
                               atol=1e-6)
    key = jax.random.key(5)
    want = np.asarray(jop.measure(jnp.asarray(x), key).y)
    k1, k2 = jax.random.split(key)
    kernel = nchw(jax.random.normal(k1, KSHAPE_J) * 1.2)
    noise = nchw(jax.random.normal(k2, want.shape))
    got = top.measure(nchw(x), noise=noise, kernel=kernel).y
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)
    xt = nchw(x).requires_grad_(True)
    g, = torch.autograd.grad(top.forward(xt).sum(), xt)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    drawn = top.draw_kernel(torch.Generator().manual_seed(0))
    assert drawn.shape == KSHAPE_T and 0.8 < float(drawn.std()) < 1.6
    with pytest.raises(AssertionError):
        jo.get_operator("nonlinear_blur")
    with pytest.raises(ValueError, match="blur_apply"):
        P.operators.get_operator("nonlinear_blur", device="cpu")


def test_poisson_noise_with_injected_counts():
    """The poisson model's clip and scale arithmetic on kdip_tpu's own
    counts: equal to kdip_tpu's output bit for bit; its own draws (from a
    generator) lie on the same 2/255 grid and average to the clipped
    data."""
    data = np.random.RandomState(4).uniform(
        -1.2, 1.2, (1, S, S, 3)).astype(np.float32)
    key = jax.random.key(6)
    want = np.asarray(jo.get_noise("poisson")(jnp.asarray(data), key))
    lam = jnp.clip((jnp.asarray(data) + 1.0) / 2.0, 0, 1) * 255.0
    counts = nchw(jax.random.poisson(key, lam).astype(jnp.float32))
    noise = P.operators.get_noise("poisson")
    np.testing.assert_array_equal(nhwc(noise(nchw(data), noise=counts)),
                                  want)
    big = torch.from_numpy(np.full((64, 3, 8, 8), 0.2, np.float32))
    draws = noise(big, generator=torch.Generator().manual_seed(0))
    steps = (draws + 1) * 127.5
    assert torch.allclose(steps, steps.round(), atol=1e-4)
    assert abs(float(draws.mean()) - 0.2) < 0.01


def _model(seed=0):
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=seed)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    fwd = lambda p, x, t: jm.apply({"params": p}, x,  # noqa: E731
                                   jnp.asarray(t, jnp.float32))
    return fwd, params, tm


def _denoisers(jop, top, gcfg, y):
    fwd, params, tm = _model()
    jcfg = jg.GuidanceConfig(**gcfg)
    tcfg = P.guidance.GuidanceConfig(**gcfg)
    ju, jv = jg.make_openai_uncond(fwd, jd.make_diffusion(1000, "linear"),
                                   jcfg)
    tu, tv = P.guidance.make_openai_uncond(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), tcfg)
    jden = jg.make_condition_denoiser(ju, jv, jop,
                                      jo.Measurement(y=jnp.asarray(y)), jcfg,
                                      params=params)
    tden = P.guidance.make_condition_denoiser(
        tu, tv, top, P.operators.Measurement(y=nchw(y)), tcfg)
    return jden, tden


MODES = {"dps": dict(guidance="dps", x0_cov_type="dps", zeta=0.3),
         "stsl": dict(guidance="stsl", x0_cov_type="dps", zeta=0.3, eta=0.5,
                      num_hutchinson_samples=1)}


@pytest.mark.parametrize("op_name", ["phase_retrieval", "nonlinear_blur"])
@pytest.mark.parametrize("mode", list(MODES))
def test_guided_denoise_on_nonlinear_operators(op_name, mode):
    """One dps or stsl denoise through the nonlinear operator at sigma 0.5
    and 2: hat_x0 within 1e-3 of kdip_tpu's (float32 in both; the gradient
    passes through the operator's FFT magnitude or blur network and the
    UNet); stsl gets kdip_tpu's probes."""
    if op_name == "phase_retrieval":
        jop = jo.PhaseRetrievalOperator(pad=PAD, sigma_s=jnp.float32(0.05))
        top = P.operators.PhaseRetrievalOperator(pad=PAD, sigma_s=0.05)
    else:
        jop, top = _blur_ops()
    ax = np.asarray(jop.forward(jnp.asarray(_image(7))))
    y = (ax + 0.05 * np.random.RandomState(8).standard_normal(ax.shape)
         ).astype(np.float32)
    jden, tden = _denoisers(jop, top, MODES[mode], y)
    jden = jax.jit(jden)
    rng = np.random.RandomState(9)
    for sigma in (0.5, 2.0):
        x = (_image(10) + sigma * rng.standard_normal((1, S, S, 3))
             ).astype(np.float32)
        key = jax.random.key(11)
        want = np.asarray(jden(jnp.asarray(x), jnp.float32(sigma), key))
        probes = None
        if mode == "stsl":
            probes = [nchw(jax.random.normal(jax.random.fold_in(key, 0),
                                             x.shape))]
        got = tden(nchw(x), sigma, probes=probes)
        np.testing.assert_allclose(nhwc(got), want, atol=1e-3,
                                   err_msg=f"sigma {sigma}")


def test_phase_retrieval_euler_trajectory_matches():
    """dps on phase retrieval through the Euler sampler, as kdip_tpu's own
    test runs it (tests/test_nonlinear_guidance.py), 3 steps from
    sigma_max 2 (hat_x0's sigma^2 cancellation stays small there, as
    tests/test_torch_sampling.py explains): final samples within 2e-3 of
    kdip_tpu's, finite and in [-1, 1]."""
    jop = jo.PhaseRetrievalOperator(pad=PAD, sigma_s=jnp.float32(0.05))
    top = P.operators.PhaseRetrievalOperator(pad=PAD, sigma_s=0.05)
    x0 = _image(12)
    key = jax.random.key(2)
    y = np.asarray(jop.measure(jnp.asarray(x0), key).y)
    jden, tden = _denoisers(jop, top, MODES["dps"], y)
    init = np.asarray(jax.random.normal(jax.random.key(3),
                                        (1, S, S, 3))) * 2.0
    want = np.asarray(js.sample_euler(
        jden, jnp.asarray(init), jsch.get_sigmas_karras(3, 0.01, 2.0),
        jax.random.key(4)))
    got = P.samplers.sample_euler(
        tden, nchw(init), P.schedules.get_sigmas_karras(3, 0.01, 2.0),
        noise_fn=lambda i: torch.zeros(1, 3, S, S))
    assert torch.isfinite(got).all() and got.abs().max() <= 1 + 1e-5
    np.testing.assert_allclose(nhwc(got), want, atol=2e-3)
