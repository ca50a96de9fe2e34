"""GuidanceConfig.remat_vjp in the port (`guidance.remat_pred`): a guided
denoise under True (`torch.utils.checkpoint`) and "conv_dots" (a selective
checkpoint keeping the conv and matmul outputs) against the same denoise
without it, port against port, bit for bit; against `kdip_tpu` under the
same setting (jax.checkpoint with its policy); the refusal of any other
value; and, on a bf16 Winograd torso, the recompute's Winograd calls,
which chip_smoke's aux_modules phase holds the card's launches to.

Tolerances: the port's remat recomputes the same float32 operations in the
same order, so its result is bit-equal to no remat. Against kdip_tpu: as
tests/test_torch_guidance.py, hat_x0 within 1e-3 (measured ~4e-5 below
the threshold) and the CG residual within 0.1% relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import kdip_tpu_torch as P
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu.models import adm as jadm
from kdip_tpu import diffusion as jd
from kdip_tpu_torch.ops import winograd as Wg
from test_torch_port import (SMALL_UNET, nchw, nhwc, one_torch_thread,  # noqa: F401
                             random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = SMALL_UNET["image_size"]
SPECS = (False, True, "conv_dots")
OP_CFG = dict(name="inpainting", sigma_s=0.05,
              mask_opt=dict(mask_type="random", mask_prob_range=(0.5, 0.5),
                            image_size=S))


@pytest.fixture(scope="module")
def setup():
    """Random SMALL_UNET weights shared by both packages, the operator and
    a measurement."""
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=21)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    jop = jo.get_operator(seed=0, **OP_CFG)
    top = P.operators.get_operator(seed=0, device="cpu", **OP_CFG)
    rng = np.random.RandomState(22)
    y = (rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
         * np.asarray(jop.mask))
    x = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    return jm, params, tm, jop, top, y, x


def port_denoise(setup, spec, cov, guidance="I", **kw):
    _, _, tm, _, top, y, _ = setup
    cfg = P.guidance.GuidanceConfig(guidance, cov, remat_vjp=spec,
                                    cg_maxiter=30, cg_warn=False, **kw)
    tu, tv = P.guidance.make_openai_uncond(
        tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"), cfg)
    return P.guidance.make_condition_denoiser(
        tu, tv, top, P.operators.Measurement(y=nchw(y)), cfg, with_info=True)


@pytest.mark.parametrize("guidance,cov,kw", [
    ("I", "convert", {}), ("I", "tmpd", {}), ("II", "tmpd", {}),
    ("pgdm", "pgdm", {}), ("dps", "dps", dict(zeta=1.0))],
    ids=["I-convert", "I-tmpd", "II-tmpd", "pgdm", "dps"])
def test_remat_is_bit_equal_to_no_remat(setup, guidance, cov, kw):
    """Every vjp mode (tmpd's two vjps of one forward among them: the
    selective checkpoint runs its region again for the second) gives the
    same bits under each remat_vjp, below the threshold and above."""
    x = setup[-1]
    for sigma in (0.1, 0.6):
        outs = [port_denoise(setup, spec, cov, guidance, **kw)(
            nchw(x[:1] * sigma), sigma) for spec in SPECS]
        for out, info in outs[1:]:
            assert torch.equal(out, outs[0][0])
            assert info == outs[0][1]


@pytest.mark.parametrize("spec", [True, "conv_dots"])
def test_remat_matches_kdip_tpu(setup, spec):
    """Convert, Type-I, one call below the threshold and one above, port
    and kdip_tpu with the same remat_vjp."""
    jm, params, _, jop, _, y, x = setup
    jcfg = jg.GuidanceConfig("I", "convert", remat_vjp=spec, cg_maxiter=30)
    ju, jv = jg.make_openai_uncond(
        lambda p, xx, t: jm.apply({"params": p}, xx,
                                  jnp.asarray(t, jnp.float32)),
        jd.make_diffusion(1000, "linear"), jcfg)
    jden = jax.jit(jg.make_condition_denoiser(
        ju, jv, jop, jo.Measurement(y=jnp.asarray(y)), jcfg, params=params,
        with_info=True))
    tden = port_denoise(setup, spec, "convert")
    for sigma in (0.1, 0.6):
        out_j, info_j = jden(jnp.asarray(x[:1] * sigma), jnp.float32(sigma))
        out_t, info_t = tden(nchw(x[:1] * sigma), sigma)
        np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=1e-3)
        np.testing.assert_allclose(info_t["cg_resid"],
                                   float(info_j["cg_resid"]), rtol=1e-3)


@pytest.mark.parametrize("bad", ["dots_saveable", "nothing_saveable", 1, 0,
                                 None])
def test_other_remat_values_are_refused(bad):
    """jax's other checkpoint_policies names have no torch counterpart:
    any value but False, True and "conv_dots" is refused, naming them."""
    with pytest.raises(ValueError, match="conv_dots"):
        P.guidance.GuidanceConfig(remat_vjp=bad)


def test_winograd_recompute_counts(monkeypatch):
    """A bf16 Winograd torso (64 px, channel_mult 1,1,2,2,4,4, so the
    FFHQ-256 count of 65 + 55 holds) through one Convert NFE below the
    threshold: the Winograd convs run winograd_per_nfe(model) times, and
    under True and "conv_dots" winograd_per_nfe(model, remat=True) (the
    backward runs the forward again; no aten op produces a Winograd
    output for "conv_dots" to keep), with the same bits."""
    calls = {k: 0 for k in Wg.launch_counts}
    plain = Wg._run

    def counting(x, v, prologue=None):
        calls["winograd_conv3x3" if prologue is None
              else "winograd_conv3x3_fused"] += 1
        return plain(x, v, prologue)
    monkeypatch.setattr(Wg, "_run", counting)
    model, tables = P.config.make_openai_model({"openai": {
        "num_channels": 32, "image_size": 64,
        "channel_mult": "1,1,2,2,4,4", "attention_resolutions": "8"}},
        winograd=True, device="cpu")
    P.weights.randomize_(model, 23)
    P.weights.precast_inference(model).eval().requires_grad_(False)
    op = P.operators.get_operator(
        seed=0, device="cpu", **dict(OP_CFG, mask_opt=dict(
            OP_CFG["mask_opt"], image_size=64)))
    g = torch.Generator().manual_seed(24)
    meas = P.operators.Measurement(y=op.forward(
        torch.rand(1, 3, 64, 64, generator=g) * 2 - 1))
    x = torch.randn(1, 3, 64, 64, generator=g) * 0.1
    outs = []
    for spec in SPECS:
        cfg = P.guidance.GuidanceConfig("I", "convert", remat_vjp=spec,
                                        cg_warn=False)
        u, v = P.guidance.make_openai_uncond(model, tables, cfg)
        den = P.guidance.make_condition_denoiser(u, v, op, meas, cfg)
        for k in calls:
            calls[k] = 0
        outs.append(den(x, 0.1))
        assert calls == chip_smoke.winograd_per_nfe(
            model, remat=spec is not False), (spec, calls)
    assert calls == {"winograd_conv3x3": 70, "winograd_conv3x3_fused": 110}
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
