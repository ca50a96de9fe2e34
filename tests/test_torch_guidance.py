"""One Type-I guided denoise of the port (`kdip_tpu_torch.guidance`) against
`kdip_tpu`'s, for the two configurations of the slice: V2 with the learned
DWT covariance (`GuidanceConfig("I", ortho_tf_type="dwt",
mle_sigma_thres=1.0)`, the CLI's --v2 default) and V1 with the Convert
covariance. Each at a sigma below its mle threshold (CG solve through the
covariance) and one above (closed form), on p=0.5 inpainting."""

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
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params

S = SMALL_UNET["image_size"]
OP_CFG = dict(name="inpainting", sigma_s=0.05,
              mask_opt=dict(mask_type="random", mask_prob_range=(0.5, 0.5),
                            image_size=S))

CONFIGS = {
    "v2-dwt": dict(guidance="I", ortho_tf_type="dwt", mle_sigma_thres=1.0),
    "v1-convert": dict(guidance="I", x0_cov_type="convert"),
    "v2-uncond": dict(guidance="uncond", ortho_tf_type="dwt",
                      mle_sigma_thres=1.0),
}


def build(name, seed=3):
    """(jax denoise, port denoise) for one configuration, with the same
    random weights, measurement and operator."""
    v2 = name.startswith("v2")
    unet = jadm.ADMUNet(**SMALL_UNET)
    jm = jadm.ADMUNetV2(unet=unet) if v2 else unet
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=seed)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    if v2:
        tm = P.adm.ADMUNetV2(tm)
    tm.load_state_dict(P.weights.from_jax_params(params))

    jtab = jd.make_diffusion(1000, "linear")
    ttab = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    jop = jo.get_operator(seed=0, **OP_CFG)
    top = P.operators.get_operator(seed=0, device="cpu", **OP_CFG)
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    y = (x0 + 0.05 * rng.standard_normal(x0.shape).astype(np.float32)
         ) * np.asarray(jop.mask)

    jcfg = jg.GuidanceConfig(**CONFIGS[name])
    tcfg = P.guidance.GuidanceConfig(**CONFIGS[name])
    jmake = jg.make_openai_v2_uncond if v2 else jg.make_openai_uncond
    ju, jv = jmake(lambda p, x, t: jm.apply({"params": p}, x,
                                            jnp.asarray(t, jnp.float32)),
                   jtab, jcfg)
    jden = jax.jit(jg.make_condition_denoiser(
        ju, jv, jop, jo.Measurement(y=jnp.asarray(y)), jcfg, params=params,
        v2=v2, with_info=True))
    tmake = (P.guidance.make_openai_v2_uncond if v2
             else P.guidance.make_openai_uncond)
    tu, tv = tmake(tm, ttab, tcfg)
    tden = P.guidance.make_condition_denoiser(
        tu, tv, top, P.operators.Measurement(y=nchw(y)), tcfg, v2=v2,
        with_info=True)
    return jden, tden


@pytest.mark.parametrize("name", list(CONFIGS))
def test_denoise_matches(name):
    """hat_x0 within 1e-3 and the CG relative residual within 0.1%. Both
    sides are float32 and sum in other orders (measured: hat_x0 within
    4e-5 below the threshold, residuals within 1e-6 relative, the same
    iteration count); above it the closed-form score is scaled by sigma^2,
    and the float32 vjp differences with it (measured 4e-4 at sigma 3)."""
    jden, tden = build(name)
    thres = CONFIGS[name].get("mle_sigma_thres", 0.2)
    rng = np.random.RandomState(11)
    xs = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    for sigma in (thres * 0.3, thres * 3.0):
        out_j, info_j = jden(jnp.asarray(xs * sigma), jnp.float32(sigma))
        out_t, info_t = tden(nchw(xs * sigma), sigma)
        np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=1e-3)
        r_j = float(info_j["cg_resid"])
        if sigma < thres and CONFIGS[name]["guidance"] == "I":
            assert 0 < info_t["cg_resid"] <= 1e-4 and info_t["cg_iters"] > 0
        else:
            assert info_t == {"cg_resid": 0.0, "cg_iters": 0}
        np.testing.assert_allclose(info_t["cg_resid"], r_j, rtol=1e-3)


def test_unported_modes_raise():
    """What the port still refuses, as kdip_tpu does: autoI with the tmpd
    covariance (its variance needs a vjp autoI does not take; every other
    covariance builds), Type-I guidance through an operator without a mat
    solver, the nonlinear blur without its network, and an unknown noise
    model."""
    y = P.operators.Measurement(y=torch.zeros(1, 3, S, S))
    for cov in ("convert", "pgdm", "dps", "diffpir", "analytic"):
        P.guidance.make_condition_denoiser(
            None, None, None, y, P.guidance.GuidanceConfig("autoI", cov))
    with pytest.raises(ValueError, match="tmpd"):
        P.guidance.make_condition_denoiser(
            None, None, None, y, P.guidance.GuidanceConfig("autoI", "tmpd"))
    op = P.operators.get_operator("phase_retrieval", device="cpu")
    x = torch.zeros(1, 3, S, S)
    den = P.guidance.make_condition_denoiser(
        lambda x, s: (x, {}), lambda *a: 0.5, op, y,
        P.guidance.GuidanceConfig("I", "pgdm"))
    with pytest.raises(NotImplementedError, match="no mat solver"):
        den(x, 0.5)
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="blur_apply"):
            P.operators.get_operator("nonlinear_blur", device=device)
    with pytest.raises(NameError, match="speckle"):
        P.operators.get_noise("speckle")
