"""Respacing, the rest of `diffusion.py` and the DDPM paths of
`kdip_tpu_torch` (diffusion.py, ddpm_sampling.py) against `kdip_tpu`'s.

The tables must match to the last float32 bit (both build them in float64
numpy and round once). The chains and the bound run over a respacing of 5
with a smooth stand-in network of (x, t) in each package, the initial x
and every step's normal kdip_tpu's (its key splits,
ddpm_sampling.py:107-117, 263-268), injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import ddpm_sampling as jds
from kdip_tpu import diffusion as jd
from test_torch_port import nchw, nhwc

SHAPE = (2, 8, 8, 3)      # kdip_tpu's NHWC


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SECTIONS = ["10", "5", "1", "250", "1000", "10,10", "3,7,20", "1,2,3,4",
            "50,0,13", "ddim25", "ddim50", "ddim100", "ddim1000", "ddim7",
            [4, 6], (100, 1, 30)]


@pytest.mark.parametrize("steps", [1000, 250, 37])
def test_space_timesteps_matches(steps):
    """space_timesteps equals kdip_tpu's kept set over section strings,
    lists and ddimN, at three schedule lengths, 40 random section lists
    among them; what kdip_tpu refuses the port refuses."""
    rng = np.random.RandomState(steps)
    cases = SECTIONS + [list(rng.randint(0, 9, rng.randint(1, 6)))
                        for _ in range(40)]
    for sec in cases:
        try:
            want = jd.space_timesteps(steps, sec)
        except ValueError:
            with pytest.raises(ValueError):
                P.diffusion.space_timesteps(steps, sec)
            continue
        assert P.diffusion.space_timesteps(steps, sec) == want, sec


def _tables_equal(tt, jt):
    assert tt._fields == jt._fields
    for name in jt._fields:
        got, want = getattr(tt, name).numpy(), np.asarray(getattr(jt, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("schedule,respacing", [
    ("linear", None), ("cosine", None), ("linear", "5"), ("linear", "ddim25"),
    ("cosine", "10,3"), ("linear", [3, 5])])
def test_tables_match_to_the_bit(schedule, respacing):
    """make_diffusion's tables and timestep_map, respaced or not, linear or
    cosine, equal kdip_tpu's bit for bit."""
    _tables_equal(
        P.diffusion.make_diffusion(1000, schedule, respacing, device="cpu"),
        jd.make_diffusion(1000, schedule, respacing))


def test_model_timesteps_and_posterior_math():
    """model_timesteps (mapped, and rescaled to 0..1000), q_sample,
    predict_eps_from_xstart, normal_kl and both classifier-guidance hooks
    within 1e-6 (2e-6) relative, the discretized Gaussian log-likelihood
    within 1e-5."""
    jt = jd.make_diffusion(1000, "linear", "ddim50")
    tt = P.diffusion.make_diffusion(1000, "linear", "ddim50", device="cpu")
    t = np.array([0, 17, 49], np.int32)
    tq = torch.from_numpy(t).long()
    for rescale in (False, True):
        np.testing.assert_array_equal(
            P.diffusion.model_timesteps(tt, tq, rescale, 1000).numpy(),
            np.asarray(jd.model_timesteps(jt, t, rescale, 1000)))
    rng = np.random.RandomState(0)
    x0, xt, noise = (rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
                     for _ in range(3))
    x0 = np.tanh(x0)

    def close(got, want, tol=1e-6):
        want = np.asarray(want)
        got = nhwc(got) if got.ndim == 4 else got.numpy()
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
    close(P.diffusion.q_sample(tt, nchw(x0), tq, nchw(noise)),
          jd.q_sample(jt, x0, t, noise))
    close(P.diffusion.predict_eps_from_xstart(tt, nchw(xt), tq, nchw(x0)),
          jd.predict_eps_from_xstart(jt, xt, t, x0))
    lv = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    close(P.ddpm_sampling.normal_kl(nchw(x0), nchw(lv), nchw(xt), 0.0),
          jds.normal_kl(x0, lv, xt, 0.0))
    # bins of x0's 8-bit values, means within a few bins, scales of a few
    # bins: away from the far tails, where the log of a difference of two
    # nearly equal cdfs takes numpy's and XLA's tanh ulps 1e3 times larger
    xb = np.round(x0 * 127.5) / np.float32(127.5)
    means, log_scales = xb + 0.01 * noise, -4.5 + 0.2 * lv
    close(P.ddpm_sampling.discretized_gaussian_log_likelihood(
        nchw(xb), means=nchw(means), log_scales=nchw(log_scales)),
        jds.discretized_gaussian_log_likelihood(
            xb, means=means, log_scales=log_scales), 1e-5)
    pmv_j = jd.p_mean_variance(jt, np.concatenate([xt, lv], -1), xt, t)
    pmv_t = P.diffusion.p_mean_variance(tt, torch.cat([nchw(xt), nchw(lv)],
                                                      1), nchw(xt), tq)
    grad_j = lambda x, t: jnp.sin(x)  # noqa: E731
    grad_t = lambda x, t: torch.sin(x)  # noqa: E731
    close(P.ddpm_sampling.condition_mean(tt, grad_t, pmv_t, nchw(xt), tq),
          jds.condition_mean(jt, grad_j, pmv_j, xt, t))
    got = P.ddpm_sampling.condition_score(tt, grad_t, pmv_t, nchw(xt), tq)
    want = jds.condition_score(jt, grad_j, pmv_j, xt, t)
    for k in ("mean", "pred_xstart"):
        close(got[k], want[k], 2e-6)


HEADS = {"learned_range": dict(learn_sigma=True),
         "fixed_large": dict(learn_sigma=False),
         "fixed_small": dict(learn_sigma=False, sigma_small=True),
         "predict_xstart": dict(learn_sigma=False, predict_xstart=True)}


def _net(xp, learn_sigma: bool):
    """A smooth stand-in for the UNet of (x, t): eps (or x0) and, with
    learn_sigma, variance values in [-1, 1] on the channel axis."""
    def jax_net(x, t):
        tt = jnp.reshape(jnp.asarray(t, jnp.float32), (-1, 1, 1, 1))
        head = jnp.tanh(x * 0.8 + 0.001 * tt)
        return (jnp.concatenate([head, jnp.tanh(2 * x - 0.002 * tt)], -1)
                if learn_sigma else head)

    def torch_net(x, t):
        tt = t.to(torch.float32).reshape(-1, 1, 1, 1)
        head = torch.tanh(x * 0.8 + 0.001 * tt)
        return (torch.cat([head, torch.tanh(2 * x - 0.002 * tt)], 1)
                if learn_sigma else head)
    return jax_net if xp is jnp else torch_net


@pytest.mark.parametrize("head", list(HEADS))
def test_p_mean_variance_heads_match(head):
    """Each variance and mean head within 1e-6 relative, clipped or not;
    the learned-range head is the one the guided path has always used."""
    jt = jd.make_diffusion(1000, "linear", "5")
    tt = P.diffusion.make_diffusion(1000, "linear", "5", device="cpu")
    kw = HEADS[head]
    rng = np.random.RandomState(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([4, 0], np.int32)
    out = _net(jnp, kw["learn_sigma"])(x, t)
    for clip in (True, False):
        want = jd.p_mean_variance(jt, out, x, t, clip, **kw)
        got = P.diffusion.p_mean_variance(
            tt, nchw(out), nchw(x), torch.from_numpy(t).long(), clip, **kw)
        for k, w in want.items():
            w, g = np.asarray(w), got[k]
            g = nhwc(g) if g.shape[1] == x.shape[-1] else g.numpy()
            g = g.reshape(w.shape) if g.size == w.size else g
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), (k, clip)


def _chain_draws(key, steps):
    """kdip_tpu's initial x and per-step normals (ddpm_sampling.py:
    107-117)."""
    k_init, k = jax.random.split(key)
    out = []
    for _ in range(steps):
        k, k_step = jax.random.split(k)
        out.append(nchw(jax.random.normal(k_step, SHAPE)))
    return nchw(jax.random.normal(k_init, SHAPE)), out


@pytest.mark.parametrize("loop,head,eta", [
    ("ancestral", "learned_range", 0.0), ("ancestral", "fixed_large", 0.0),
    ("ancestral", "fixed_small", 0.0), ("ddim", "learned_range", 0.0),
    ("ddim", "learned_range", 0.5), ("ddim", "fixed_large", 0.5)])
def test_chains_match(loop, head, eta):
    """p_sample_loop and ddim_sample_loop over a respacing of 5 with
    kdip_tpu's draws: within 1e-5 of the largest |x| (measured ~1e-7;
    pred_xstart multiplies eps by up to 157 at t = 999)."""
    jt = jd.make_diffusion(1000, "linear", "5")
    tt = P.diffusion.make_diffusion(1000, "linear", "5", device="cpu")
    kw = HEADS[head]
    key = jax.random.key(3)
    init, steps = _chain_draws(key, 5)
    if loop == "ancestral":
        want = jds.p_sample_loop(jt, _net(jnp, kw["learn_sigma"]), SHAPE,
                                 key, **kw)
        got = P.ddpm_sampling.p_sample_loop(
            tt, _net(torch, kw["learn_sigma"]), None, noise=init,
            noise_fn=steps.__getitem__, device="cpu", **kw)
    else:
        want = jds.ddim_sample_loop(jt, _net(jnp, kw["learn_sigma"]), SHAPE,
                                    key, eta=eta, **kw)
        got = P.ddpm_sampling.ddim_sample_loop(
            tt, _net(torch, kw["learn_sigma"]), None, eta=eta, noise=init,
            noise_fn=steps.__getitem__, device="cpu", **kw)
    want = np.asarray(want)
    assert np.abs(nhwc(got) - want).max() <= 1e-5 * np.abs(want).max()


def test_calc_bpd_loop_matches():
    """calc_bpd_loop over a respacing of 5 with kdip_tpu's q-sample noise
    (ddpm_sampling.py:263-268): every term within 1e-5 relative of its
    largest (vb, mse and xstart_mse [B, T] in the same order), and
    prior_bpd."""
    jt = jd.make_diffusion(1000, "linear", "5")
    tt = P.diffusion.make_diffusion(1000, "linear", "5", device="cpu")
    x0 = np.round(np.tanh(np.random.RandomState(4).standard_normal(SHAPE))
                  * 127.5).astype(np.float32) / np.float32(127.5)
    key = jax.random.key(5)
    noise, k = [], key
    for _ in range(5):
        k, k_step = jax.random.split(k)
        noise.append(nchw(jax.random.normal(k_step, SHAPE)))
    want = jds.calc_bpd_loop(jt, _net(jnp, True), x0, key)
    got = P.ddpm_sampling.calc_bpd_loop(tt, _net(torch, True), nchw(x0),
                                        noise_fn=noise.__getitem__)
    assert set(got) == set(want)
    for name, w in want.items():
        w, g = np.asarray(w), got[name].numpy()
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name
