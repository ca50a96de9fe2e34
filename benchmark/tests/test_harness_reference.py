"""The plain reference computes what the program's float32 path computes:
the model, the Haar DWT, the sampler's schedule and churn, and the guided
x0 estimate in both regimes, for DWT-Var and for Convert (the program on
the CPU in float32, its torso not cast; the reference imports none of it:
this test holds the two side by side)."""

import numpy as np
import pytest
import torch

import tiny
from harness import check, inputs
from reference import guided


def test_haar_is_the_programs_packed_layout():
    from kdip_tpu_torch.ops import dwt
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    for level in (1, 2, 3):
        assert torch.equal(guided.haar(x, level), dwt.dwt2_plain(x, level))
        assert torch.equal(guided.ihaar(x, level), dwt.idwt2_plain(x, level))


def test_schedule_is_the_samplers():
    from kdip_tpu_torch import samplers, schedules
    sch = guided.Schedule(50, 0.01, 80.0, 7.0, 80.0, 0.05, 50.0, 1.003)
    sig = schedules.get_sigmas_karras(50, 0.01, 80.0, 7.0).numpy()
    assert np.array_equal(sch.sigmas, sig)
    assert np.array_equal(sch.gammas,
                          samplers._churn_gammas(sig, 80.0, 0.05, 50.0))
    assert len(sch.call_sigmas()) == 99


def _pair(kind):
    """(cell, program model float32, its tables, reference model, the
    reference's moments, weights)."""
    from families import adm as fam
    c = tiny.cell(kind)
    cfg = dict(c.config, precision="float32", winograd=False)
    ref = fam.reference_model(cfg)
    state = inputs.weights([(n, p.shape) for n, p in ref.named_parameters()],
                           fam.norm_names(ref), 3, 0.02, "cpu")
    model, tables = fam.program_model(cfg, state, "cpu")
    ref.load_state_dict(state, assign=True)
    ref.requires_grad_(False)
    return c, cfg, model, tables, ref, fam.reference_moments(cfg, ref, "cpu")


@pytest.mark.parametrize("kind", ["dwt_var", "winograd_convert"])
def test_guided_x0_is_the_programs_at_float32(kind):
    from kdip_tpu_torch import guidance as gd
    from kdip_tpu_torch.operators import Measurement
    from operators import inpainting
    c, cfg, model, tables, ref, moments = _pair(kind)
    shape = (2, 3, 32, 32)
    drawn = inpainting.draw(c.traffic["operator"], 5, shape, "cpu")
    y = inpainting.measure(c.traffic["operator"], drawn,
                           inputs.images(5, 0, shape, "cpu"),
                           inputs.noise(5, "measure", 0, 0, shape, "cpu"))
    op = inpainting.program(c.traffic["operator"], drawn, "cpu")
    g = cfg["guidance"]
    gcfg = gd.GuidanceConfig(
        guidance="I", x0_cov_type=g["x0_cov_type"],
        mle_sigma_thres=g["mle_sigma_thres"],
        ortho_tf_type=g["ortho_tf_type"], cg_tol=g["cg_tol"])
    v2 = bool(cfg["model"].get("v2"))
    uncond = (gd.make_openai_v2_uncond if v2 else gd.make_openai_uncond)(
        model, tables, gcfg)
    den = gd.make_condition_denoiser(*uncond, op, Measurement(y), gcfg,
                                     v2=v2, with_info=True)
    problem = inpainting.reference(c.traffic["operator"], drawn, y)
    thres = g["mle_sigma_thres"]
    log_sigmas = guided.linear_tables(1000, "cpu").log_sigmas
    for sigma in (40.0, 3.0, thres * 0.9, 0.05):
        x = inputs.noise(5, "x", 0, 0, shape, "cpu") * sigma
        d_prog, info = den(x, sigma)
        d_ref, raw = guided.guided_x0(moments, problem, g, x, sigma)
        assert (info["cg_iters"] > 0) == (sigma < thres)
        assert check.step_err(d_prog, d_ref, x) < 1e-9, sigma
        t = guided.sigma_to_t(log_sigmas, sigma)
        out = model(x * guided.c_in(sigma),
                    torch.full((2,), t if v2 else float(int(t))))
        for a, b in zip(out if v2 else (out,), raw if v2 else (raw,)):
            assert check.err(a, b) < 1e-10
