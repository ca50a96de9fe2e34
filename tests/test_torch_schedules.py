"""The port's schedules, DDPM tables and preconditioning against `kdip_tpu`'s
(schedules.py, diffusion.py, precond.py)."""

import jax.numpy as jnp
import numpy as np
import torch

import kdip_tpu_torch as P
from kdip_tpu import diffusion as jd
from kdip_tpu import guidance as jg
from kdip_tpu import precond as jp
from kdip_tpu import schedules as js
from test_torch_port import nchw, nhwc


def test_ddpm_tables_exact():
    """Both packages build the tables in float64 numpy and round once to
    float32, so every table, log_sigmas included, is bit-identical."""
    jt = jd.make_diffusion(1000, "linear")
    tt = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    for name in P.diffusion.DiffusionTables._fields:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    assert tt.num_timesteps == 1000


def test_karras_schedule_matches():
    """float32 Karras sigmas (rtol 2e-6: a few ulp of a float32 pow)."""
    for n in (4, 50):
        np.testing.assert_allclose(
            P.schedules.get_sigmas_karras(n, 1e-2, 80.0, 7.0).numpy(),
            np.asarray(js.get_sigmas_karras(n, 1e-2, 80.0, 7.0)), rtol=2e-6)


def test_sigma_to_t_both_modes():
    """Fractional t (V2) within 2e-4, a few float32 ulp at t ~ 1000; the
    floor that V1 takes (guidance.py:157) exactly. The sigmas span the
    table, its ends and beyond."""
    jt = jd.make_diffusion(1000, "linear")
    ls_t = P.diffusion.make_diffusion(1000, "linear", device="cpu").log_sigmas
    rng = np.random.RandomState(0)
    sig = np.concatenate([np.exp(rng.uniform(np.log(5e-3), np.log(200), 64)),
                          [0.01, 0.2, 1.0, 80.0, float(ls_t[0].exp()),
                           float(ls_t[-1].exp())]]).astype(np.float32)
    t_j = np.asarray(jp.sigma_to_t(jt.log_sigmas, jnp.asarray(sig)))
    t_t = P.precond.sigma_to_t(ls_t, torch.tensor(sig)).numpy()
    np.testing.assert_allclose(t_t, t_j, atol=2e-4)
    np.testing.assert_array_equal(t_t.astype(np.int32), t_j.astype(np.int32))


def test_scalings_and_mle_var():
    for s in (0.01, 0.2, 1.0, 80.0):
        s32 = np.float32(s)
        c_out, c_in = P.precond.eps_scalings(s32)
        j_out, j_in = jp.eps_scalings(jnp.float32(s))
        assert float(c_out) == float(j_out)
        np.testing.assert_allclose(float(c_in), float(j_in), rtol=1e-7)
        np.testing.assert_allclose(P.guidance.mle_var(s),
                                   float(jg.mle_var(jnp.float32(s))),
                                   rtol=1e-7)


def test_p_mean_variance_and_convert():
    """p_mean_variance (learn_sigma, clipped) and the Eq. 22 Convert
    variance from the same raw output, rtol 1e-5 (float32 elementwise
    chains, exp of the interpolated log-variance). Eq. 22 subtracts two
    close variances and divides by coef1^2, so its error is held to 1e-5 of
    variance / coef1^2 instead."""
    jt = jd.make_diffusion(1000, "linear")
    tt = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    out = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    out[..., 3:] = np.tanh(out[..., 3:])
    t = np.array([3, 700], np.int32)
    j = jd.p_mean_variance(jt, jnp.asarray(out), jnp.asarray(x),
                           jnp.asarray(t))
    p = P.diffusion.p_mean_variance(tt, nchw(out), nchw(x),
                                    torch.tensor(t, dtype=torch.int64))
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(nhwc(p[k]), np.asarray(j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(p["pred_xstart"].abs().max()) <= 1.0
    cj = jd.convert_x0_var(jt, j["variance"], jnp.asarray(t))
    ct = P.diffusion.convert_x0_var(tt, p["variance"],
                                    torch.tensor(t, dtype=torch.int64))
    c1 = tt.posterior_mean_coef1[torch.tensor(t, dtype=torch.int64)]
    scale = float((p["variance"] / c1[:, None, None, None] ** 2).max())
    np.testing.assert_allclose(nhwc(ct), np.asarray(cj), rtol=1e-5,
                               atol=1e-5 * scale)


def test_append_dims_and_to_d():
    x = torch.ones(2, 3, 4, 4)
    s = torch.tensor([1.0, 2.0])
    assert P.schedules.append_dims(s, 4).shape == (2, 1, 1, 1)
    d = P.schedules.to_d(x, s, torch.zeros_like(x))
    np.testing.assert_allclose(nhwc(d), np.asarray(js.to_d(
        jnp.ones((2, 4, 4, 3)), jnp.asarray([1.0, 2.0]),
        jnp.zeros((2, 4, 4, 3)))))
    assert torch.equal(P.schedules.to_d(x, 2.0, torch.zeros_like(x)), x / 2)
