"""The rest of the sampler zoo, its schedules, the denoiser adapters and the
Brownian tree of `kdip_tpu_torch` against `kdip_tpu`'s (schedules.py,
precond.py, brownian.py, samplers.py:181-832).

The samplers run with the analytic denoiser x / (1 + sigma^2) and once on
the 16 px UNet through `precond.make_discrete_eps_denoiser`; their draws
are `kdip_tpu`'s, replayed from its key splits (samplers.py:189, 210, 244,
329, 571), and the SDE samplers' noise is `kdip_tpu`'s Brownian tree
answering each of the port's (sigma, sigma') queries. Errors are relative
to the largest |x| of kdip_tpu's output unless said otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import brownian as jb
from kdip_tpu import diffusion as jd
from kdip_tpu import precond as jp
from kdip_tpu import samplers as js
from kdip_tpu import schedules as jsch
from kdip_tpu.models import adm as jadm
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params

SHAPE = (2, 4, 4, 3)          # kdip_tpu's NHWC


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def analytic(x, sigma):
    """The exact posterior mean x / (1 + sigma^2) of N(0, I) data, its
    scalar float32 in both packages: the solvers' x - D(x) cancels to 1e-4
    of x at sigma 0.01, so a float64 scalar on one side would show."""
    if isinstance(sigma, float):
        return x / float(np.float32(1) + np.float32(sigma) ** 2)
    return x / (1 + sigma ** 2)


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(nhwc(got) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# schedules and the ancestral split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("exponential", (12, 0.01, 80.0)),
    ("polyexponential", (12, 0.01, 80.0)),
    ("polyexponential", (12, 0.002, 157.0, 2.0)),
    ("vp", (12,)), ("vp", (7, 18.0, 0.2, 1e-2))])
def test_schedules_match(name, args):
    """Each new schedule within 1e-6 relative of kdip_tpu's (measured: at
    most 2 float32 ulps, ~2.4e-7), zero-terminated."""
    want = np.asarray(getattr(jsch, f"get_sigmas_{name}")(*args))
    got = getattr(P.schedules, f"get_sigmas_{name}")(*args).numpy()
    assert got.shape == want.shape and got[-1] == 0 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
def test_ancestral_step_matches(eta):
    """get_ancestral_step over descending pairs, sigma_to 0 included: within
    1e-6 relative (float32 on both sides)."""
    sig = np.asarray(jsch.get_sigmas_karras(9, 0.01, 80.0))
    jd_, ju = jsch.get_ancestral_step(sig[:-1], sig[1:], eta)
    td, tu = P.schedules.get_ancestral_step(sig[:-1], sig[1:], eta)
    np.testing.assert_allclose(np.broadcast_to(td, sig[1:].shape),
                               np.asarray(jd_), rtol=1e-6, atol=0)
    np.testing.assert_allclose(np.broadcast_to(tu, sig[1:].shape),
                               np.asarray(ju), rtol=1e-6, atol=0)
    for a, b in zip(sig[:-1], sig[1:]):     # the samplers' scalar calls
        d, u = P.schedules.get_ancestral_step(a, b, eta)
        assert d.dtype == u.dtype == np.float32


# ---------------------------------------------------------------------------
# precond: sigma <-> t and the denoiser factories
# ---------------------------------------------------------------------------

LOG_SIGMAS = np.array(jd.make_diffusion(1000, "linear").log_sigmas)


@pytest.mark.parametrize("quantize", [False, True])
def test_sigma_to_t_and_back(quantize):
    """sigma_to_t on 64 sigmas across (and beyond) the table, both modes,
    within 1e-6 relative (quantized: equal); t_to_sigma on fractional t
    and schedule_sigmas (the table reversed, and interpolated to 10)
    within 1e-6 relative."""
    sig = np.geomspace(0.005, 200.0, 64).astype(np.float32)
    ls = torch.from_numpy(LOG_SIGMAS)
    want = np.asarray(jp.sigma_to_t(jnp.asarray(LOG_SIGMAS), sig, quantize))
    got = P.precond.sigma_to_t(ls, torch.from_numpy(sig), quantize).numpy()
    if quantize:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        return
    np.testing.assert_allclose(got, want, rtol=1e-6)
    t = np.linspace(0, 999, 37).astype(np.float32) + np.float32(0.3)
    t[-1] = 999.0
    np.testing.assert_allclose(
        P.precond.t_to_sigma(ls, torch.from_numpy(t)).numpy(),
        np.asarray(jp.t_to_sigma(jnp.asarray(LOG_SIGMAS), t)), rtol=1e-6)
    for n in (None, 10):
        np.testing.assert_allclose(
            P.precond.schedule_sigmas(ls, n).numpy(),
            np.asarray(jp.schedule_sigmas(jnp.asarray(LOG_SIGMAS), n)),
            rtol=1e-6)


def _model(xp):
    """A smooth stand-in network of (x_scaled, t) in each package."""
    if xp is jnp:
        return lambda params, x, t: jnp.tanh(x) * (1 + 0.001 * jnp.reshape(
            jnp.asarray(t, jnp.float32), (-1, 1, 1, 1)))
    return lambda x, t: torch.tanh(x) * (1 + 0.001 * torch.as_tensor(
        t, dtype=torch.float32).reshape(-1, 1, 1, 1))


@pytest.mark.parametrize("factory", [
    "edm", "v", "discrete_eps", "discrete_eps_quantized", "discrete_v",
    "compvis_eps", "compvis_v"])
def test_denoiser_factories_match(factory):
    """Each factory's denoiser at a host sigma and at per-sample sigmas,
    within 1e-6 relative of kdip_tpu's (measured ~1e-7)."""
    ac = np.array(jd.make_diffusion(1000, "linear").alphas_cumprod)
    ls = jnp.asarray(LOG_SIGMAS)
    quantize = factory.endswith("quantized")
    kind = factory.replace("_quantized", "")
    jargs = {"edm": (), "v": (), "discrete_eps": (ls, quantize),
             "discrete_v": (ls,), "compvis_eps": (ac,), "compvis_v": (ac,)}
    targs = {"edm": (), "v": (),
             "discrete_eps": (torch.from_numpy(LOG_SIGMAS), quantize),
             "discrete_v": (torch.from_numpy(LOG_SIGMAS),),
             "compvis_eps": (torch.from_numpy(ac),),
             "compvis_v": (torch.from_numpy(ac),)}
    jden = getattr(jp, f"make_{kind}_denoiser")(_model(jnp), *jargs[kind])
    tden = getattr(P.precond, f"make_{kind}_denoiser")(_model(torch),
                                                       *targs[kind])
    x = np.random.RandomState(0).standard_normal(SHAPE).astype(np.float32)
    for sigma in (np.float32(0.7), np.array([0.05, 30.0], np.float32)):
        want = np.asarray(jden(None, jnp.asarray(x * 3), jnp.asarray(sigma)))
        arg = float(sigma) if sigma.ndim == 0 else torch.from_numpy(sigma)
        got = tden(nchw(x * 3), arg)
        assert rel_err(got, want) <= 1e-6
    np.testing.assert_allclose(
        P.precond.sigmas_from_alphas_cumprod(ac).numpy(),
        np.asarray(jp.sigmas_from_alphas_cumprod(ac)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The Brownian tree
# ---------------------------------------------------------------------------

def _tree(seed=0, shape=(2, 3, 8, 8), lo=0.05, hi=80.0):
    return P.brownian.BrownianTreeNoiseSampler(shape, lo, hi, seed,
                                               device="cpu")


def test_brownian_increments_add_up():
    """W increments are additive, as tests/test_samplers.py:131 holds
    kdip_tpu's: the unscaled noise of 80 -> 1 and 1 -> 0.05 sums to that of
    80 -> 0.05 (float32 sums: within 1e-5 of the largest)."""
    ns = _tree()
    n_a = ns(80.0, 1.0) * np.sqrt(80.0 - 1.0)
    n_b = ns(1.0, 0.05) * np.sqrt(1.0 - 0.05)
    n_ab = ns(80.0, 0.05) * np.sqrt(80.0 - 0.05)
    assert ((n_a + n_b - n_ab).abs().max() <= 1e-5 * n_ab.abs().max())


def test_brownian_is_a_function_of_seed_and_t():
    """The same W at each t whatever the order and nesting of the queries,
    or a fresh tree of the same seed; another seed draws another path.
    Each query draws 1 + depth nodes."""
    ts = [80.0, 0.05, 3.7, 3.7000002, 12.5, 0.3, 79.99]
    a, b = _tree(), _tree()
    wa = {t: a.w(t) for t in ts}
    wb = {t: b.w(t) for t in reversed(ts)}
    assert all(torch.equal(wa[t], wb[t]) for t in ts)
    assert torch.equal(a.w(12.5), wa[12.5]) and a.queries == len(ts) + 1
    assert not torch.equal(_tree(seed=1).w(12.5), wa[12.5])
    assert torch.equal(a(3.7, 0.3), b(3.7, 0.3))


def test_brownian_increments_are_unit_normal():
    """Over 400 seeds of 3 x 8 x 8 values (76,800 draws a case), the
    normalized increment of a long, a short and a nested interval has mean
    0 and variance 1 within 5 standard errors of each."""
    n = 400
    for s0, s1 in ((80.0, 0.05), (2.0, 1.5), (0.31, 0.3)):
        z = torch.stack([_tree(seed, (3, 8, 8))(s0, s1) for seed in range(n)])
        se = 1 / np.sqrt(z.numel())
        assert abs(z.mean().item()) <= 5 * se
        assert abs(z.var().item() - 1) <= 5 * np.sqrt(2) * se


def test_brownian_samples_from_kdip_tpus_construction():
    """Fed kdip_tpu's node draws (its fold_in keys), the port's bisection
    gives kdip_tpu's W within 1e-6 of its largest, at the ends, inside and
    a hair apart: the descent, node ids and variances are the same."""
    key = jax.random.key(7)
    shape = (1, 2, 2, 3)
    jt = jb.BrownianTreeNoiseSampler(shape, 0.05, 80.0, key, depth=10)
    tt = P.brownian.BrownianTreeNoiseSampler((1, 3, 2, 2), 0.05, 80.0, 0,
                                             device="cpu", depth=10)
    draw = jax.jit(lambda node: jax.random.normal(
        jax.random.fold_in(key, node), shape))
    tt._draw = lambda node, std: nchw(draw(node)) * float(std)
    ts = (80.0, 0.05, 7.3, 2.2, 0.4, 0.3999)
    jw = jax.jit(jt._w)
    want = np.stack([np.asarray(jw(jnp.float32(t))) for t in ts])
    got = np.stack([nhwc(tt.w(t)) for t in ts])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The samplers, analytic denoiser
# ---------------------------------------------------------------------------

def _split_draws(key, steps, n_split, at):
    """kdip_tpu's per-step normals: split(key, n_split) a step, the draw
    from part `at` (part 0 carries the key)."""
    out = []
    for _ in range(steps):
        parts = jax.random.split(key, n_split)
        key = parts[0]
        out.append(nchw(jax.random.normal(parts[at], SHAPE)))
    return out


class _Replay:
    """A noise_sampler that hands out given draws in call order."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def __call__(self, sigma, sigma_next):
        self.calls += 1
        return self.draws.pop(0)


def tree_replay(key, sig, shape=SHAPE):
    """kdip_tpu's Brownian tree (split(key)[1], samplers.py:363) answering
    the port's queries, jitted as the sampler's scan runs it: W is rough,
    so the ulp by which XLA's compiled and eager descents can part moves
    it by ~sqrt(ulp)."""
    _, tree_key = jax.random.split(key)
    tree = jb.BrownianTreeNoiseSampler(shape, float(sig[sig > 0].min()),
                                       float(sig.max()), tree_key)
    query = jax.jit(lambda s, sn: tree(s, sn))
    return lambda s, sn: nchw(query(jnp.float32(s), jnp.float32(sn)))


STEPS = 6
# measured: 1e-7 .. 6e-7 (float32 host scalars against float32 device
# scalars); the SDE samplers 1e-7 where they query the schedule's own
# sigmas (2M SDE), and dpmpp_sde 5.1e-5, whose step-1 sigmas numpy's and
# XLA's exp/log round an ulp apart (W moves ~sqrt(ulp))
ODE_RTOL, SDE_RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("name", [
    "euler_ancestral", "dpm_2", "dpm_2_churn", "dpm_2_ancestral", "lms",
    "dpmpp_2s_ancestral", "dpmpp_sde", "dpmpp_2m_sde_midpoint",
    "dpmpp_2m_sde_heun"])
def test_analytic_trajectory_matches(name):
    """6 steps from sigma_max 80 with the analytic denoiser and kdip_tpu's
    draws: the port's samples within ODE_RTOL (SDE_RTOL for the Brownian
    samplers) of kdip_tpu's."""
    sig_j = jsch.get_sigmas_karras(STEPS, 0.01, 80.0)
    sig = np.asarray(sig_j)
    sig_t = torch.from_numpy(sig.copy())
    x = (80.0 * np.random.RandomState(0).standard_normal(SHAPE)
         ).astype(np.float32)
    key = jax.random.key(5)
    jden = lambda x, s, k: analytic(x, s)  # noqa: E731
    churn = dict(s_churn=80.0, s_tmin=0.05, s_tmax=50.0, s_noise=1.003)
    rtol = ODE_RTOL
    if name == "euler_ancestral":
        want = js.sample_euler_ancestral(jden, x, sig_j, key)
        got = P.samplers.sample_euler_ancestral(
            analytic, nchw(x), sig_t,
            noise_sampler=_Replay(_split_draws(key, STEPS, 3, 1)))
    elif name in ("dpm_2", "dpm_2_churn"):
        kw = churn if name == "dpm_2_churn" else {}
        want = js.sample_dpm_2(jden, x, sig_j, key, **kw)
        got = P.samplers.sample_dpm_2(
            analytic, nchw(x), sig_t,
            noise_fn=_split_draws(key, STEPS, 4, 1).__getitem__, **kw)
    elif name == "dpm_2_ancestral":
        want = js.sample_dpm_2_ancestral(jden, x, sig_j, key, eta=0.8)
        got = P.samplers.sample_dpm_2_ancestral(
            analytic, nchw(x), sig_t, eta=0.8,
            noise_sampler=_Replay(_split_draws(key, STEPS, 4, 1)))
    elif name == "lms":
        want = js.sample_lms(jden, x, sig_j, key)
        got = P.samplers.sample_lms(analytic, nchw(x), sig_t)
    elif name == "dpmpp_2s_ancestral":
        want = js.sample_dpmpp_2s_ancestral(jden, x, sig_j, key, s_noise=0.9)
        got = P.samplers.sample_dpmpp_2s_ancestral(
            analytic, nchw(x), sig_t, s_noise=0.9,
            noise_sampler=_Replay(_split_draws(key, STEPS, 4, 1)))
    elif name == "dpmpp_sde":
        rtol = SDE_RTOL
        want = js.sample_dpmpp_sde(jden, x, sig_j, key)
        got = P.samplers.sample_dpmpp_sde(analytic, nchw(x), sig_t,
                                          noise_sampler=tree_replay(key, sig))
    else:
        rtol = SDE_RTOL
        solver = name.rsplit("_", 1)[1]
        want = js.sample_dpmpp_2m_sde(jden, x, sig_j, key, eta=0.7,
                                      solver_type=solver)
        got = P.samplers.sample_dpmpp_2m_sde(
            analytic, nchw(x), sig_t, eta=0.7, solver_type=solver,
            noise_sampler=tree_replay(key, sig))
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= rtol


def test_lms_coefficients_match_quad():
    """linear_multistep_coeff's Gauss-Legendre rule against kdip_tpu's
    scipy quad on a 12-step Karras schedule, every order up to 4: within
    1e-6 relative (measured ~1e-15: the integrand is a polynomial)."""
    sig = np.asarray(jsch.get_sigmas_karras(12, 0.01, 80.0))
    for i in range(len(sig) - 1):
        for order in range(1, min(i + 1, 4) + 1):
            for j in range(order):
                want = js.linear_multistep_coeff(order, sig, i, j)
                got = P.samplers.linear_multistep_coeff(order, sig, i, j)
                assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12)
    with pytest.raises(ValueError, match="exceeds"):
        P.samplers.linear_multistep_coeff(3, sig, 1, 0)


# DPM-Solver's first step from sigma 80 shrinks x 25-80 times in one product
# of host scalars, so an ulp between numpy's exp/expm1 and XLA's shows that
# much larger (measured: 2.6e-5 at n=7, 1.9e-6 at n=9, 1.5e-5 with eta).
# The adaptive solver's step sizes also come from its error read, the norm
# of x_low - x_high, two nearly equal tensors: its float32 noise moves h
# (measured: 2.2e-4 at the defaults, 5e-6 and 4e-7 at the tighter
# settings), while the accept/reject sequence is held exactly.
FAST_RTOL, ADAPTIVE_RTOL = 1e-4, 5e-4


@pytest.mark.parametrize("n,eta", [(7, 0.0), (9, 0.0), (8, 0.6)])
def test_dpm_fast_matches(n, eta):
    """DPM-Solver-Fast with n calls (orders 3,3,1 / 3,3,2,1 / 3,3,2), with
    and without eta (kdip_tpu's normals replayed): within FAST_RTOL."""
    x = (80.0 * np.random.RandomState(1).standard_normal(SHAPE)
         ).astype(np.float32)
    key = jax.random.key(2)
    want = js.sample_dpm_fast(lambda x, s, k: analytic(x, s), x, 0.01, 80.0,
                              n, key, eta=eta)
    calls = []

    def counted(x, sigma):
        calls.append(sigma)
        return analytic(x, sigma)
    got = P.samplers.sample_dpm_fast(
        counted, nchw(x), 0.01, 80.0, n, eta=eta,
        noise_fn=_split_draws(key, n, 3, 2).__getitem__)
    assert len(calls) == n
    assert rel_err(got, want) <= FAST_RTOL


def _record_pid(module, monkeypatch):
    """Records each accept decision of module.PIDStepSizeController."""
    seq = []
    real = module.PIDStepSizeController.propose_step

    def propose(self, error):
        seq.append(real(self, error))
        return seq[-1]
    monkeypatch.setattr(module.PIDStepSizeController, "propose_step", propose)
    return seq


@pytest.mark.parametrize("order,h_init,rtol,atol", [
    (3, 0.05, 0.05, 0.0078), (3, 3.0, 1e-3, 1e-4), (2, 1.0, 1e-3, 1e-3)])
def test_dpm_adaptive_takes_the_same_steps(order, h_init, rtol, atol,
                                           monkeypatch):
    """DPM-Solver-12/23 adaptive, the defaults and two tighter settings
    (9, 13 and 37 steps with 1, 2 and 4 rejected): the same accept/reject
    sequence, steps and NFE count as kdip_tpu, the samples within
    ADAPTIVE_RTOL; the denoiser is called `order` times a step."""
    x = (80.0 * np.random.RandomState(2).standard_normal(SHAPE)
         ).astype(np.float32)
    seq_j = _record_pid(js, monkeypatch)
    want, info_j = js.sample_dpm_adaptive(
        lambda x, s, k: analytic(x, s), jnp.asarray(x), 0.01, 80.0,
        jax.random.key(0), order=order, h_init=h_init, rtol=rtol, atol=atol,
        return_info=True)
    seq_t = _record_pid(P.samplers, monkeypatch)
    calls = []

    def counted(x, sigma):
        calls.append(sigma)
        return analytic(x, sigma)
    got, info_t = P.samplers.sample_dpm_adaptive(
        counted, nchw(x), 0.01, 80.0, order=order, h_init=h_init, rtol=rtol,
        atol=atol, return_info=True)
    assert seq_t == seq_j and info_t == info_j
    assert len(calls) == info_t["nfe"] and info_t["n_reject"] >= 1
    assert rel_err(got, want) <= ADAPTIVE_RTOL


# ---------------------------------------------------------------------------
# The log-likelihood
# ---------------------------------------------------------------------------

def test_log_likelihood_matches():
    """Fixed-step RK4 (4 steps, 16 fevals) and dopri5 (its steps, fevals
    and value) with the analytic denoiser and kdip_tpu's Rademacher probe:
    within 1e-5 relative (measured ~1e-7)."""
    x = np.random.RandomState(3).standard_normal(SHAPE).astype(np.float32)
    key = jax.random.key(4)
    v = nchw(jax.random.rademacher(jax.random.split(key)[0], SHAPE,
                                   dtype=jnp.float32))
    jden = lambda x, s, k: analytic(x, s)  # noqa: E731
    want, info_j = js.log_likelihood(jden, jnp.asarray(x), 0.01, 80.0, key,
                                     steps=4)
    got, info_t = P.samplers.log_likelihood(analytic, nchw(x), 0.01, 80.0,
                                            steps=4, probe=v)
    assert info_t == info_j == {"fevals": 16}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    want, info_j = js.log_likelihood_adaptive(jden, jnp.asarray(x), 0.01,
                                              80.0, key, atol=1e-3, rtol=1e-3)
    got, info_t = P.samplers.log_likelihood_adaptive(
        analytic, nchw(x), 0.01, 80.0, atol=1e-3, rtol=1e-3, probe=v)
    assert info_t == {k: int(v) for k, v in info_j.items()}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    _, info_t = P.samplers.log_likelihood_adaptive(
        analytic, nchw(x), 0.01, 80.0, atol=1e-3, rtol=1e-3, probe=v,
        max_steps=3)
    assert info_t == {"fevals": 19, "steps": 3}


# ---------------------------------------------------------------------------
# The samplers on the 16 px UNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_denoisers():
    """(kdip_tpu's, the port's) discrete eps denoiser over the 16 px UNet,
    random weights, eps channels only."""
    S = SMALL_UNET["image_size"]
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=8)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    tm.eval().requires_grad_(False)
    jtab = jd.make_diffusion(1000, "linear")
    jden = jp.make_discrete_eps_denoiser(
        lambda p, x, t: jm.apply({"params": p}, x, jnp.broadcast_to(
            jnp.asarray(t, jnp.float32), (x.shape[0],)))[..., :3],
        jtab.log_sigmas)
    tden = P.precond.make_discrete_eps_denoiser(
        lambda x, t: tm(x, t)[:, :3], torch.from_numpy(LOG_SIGMAS))
    return (lambda x, s, k: jden(params, x, s)), tden


@pytest.mark.parametrize("name", [
    "euler_ancestral", "dpm_2_ancestral", "dpmpp_2s_ancestral",
    "dpmpp_2m_sde", "dpm_fast", "dpm_adaptive"])
def test_unet_trajectory_matches(unet_denoisers, name):
    """Each sampler no CLI flag reaches, 3 steps (dpm_fast 4 calls;
    dpm_adaptive at rtol 0.5, atol 0.1) from sigma_max 80 on the 16 px
    UNet, 2 samples, kdip_tpu's draws: within 5e-5 relative. Measured
    5e-7 to 9e-7, and 2.5e-5 for dpm_2_ancestral: its sigma_mid comes from
    numpy's exp/log on the host, an ulp from XLA's, and the UNet's timestep
    embedding sin(t f) moves ~1e-5 per ulp of t near 900."""
    jden, tden = unet_denoisers
    S = SMALL_UNET["image_size"]
    shape = (2, S, S, 3)
    x = (80.0 * np.random.RandomState(4).standard_normal(shape)
         ).astype(np.float32)
    key = jax.random.key(6)
    sig_j = jsch.get_sigmas_karras(3, 0.01, 80.0)
    sig_t = torch.from_numpy(np.asarray(sig_j).copy())

    def draws(n_split, at):
        out, k = [], key
        for _ in range(3):
            parts = jax.random.split(k, n_split)
            k = parts[0]
            out.append(nchw(jax.random.normal(parts[at], shape)))
        return _Replay(out)
    fn = jax.jit(lambda x: {
        "euler_ancestral": lambda: js.sample_euler_ancestral(
            jden, x, sig_j, key),
        "dpm_2_ancestral": lambda: js.sample_dpm_2_ancestral(
            jden, x, sig_j, key),
        "dpmpp_2s_ancestral": lambda: js.sample_dpmpp_2s_ancestral(
            jden, x, sig_j, key),
        "dpmpp_2m_sde": lambda: js.sample_dpmpp_2m_sde(jden, x, sig_j, key),
        "dpm_fast": lambda: js.sample_dpm_fast(jden, x, 0.01, 80.0, 4, key),
    }[name]()) if name != "dpm_adaptive" else None
    if name == "dpm_adaptive":
        want, info_j = js.sample_dpm_adaptive(
            jden, jnp.asarray(x), 0.01, 80.0, key, rtol=0.5, atol=0.1,
            return_info=True)
        got, info_t = P.samplers.sample_dpm_adaptive(
            tden, nchw(x), 0.01, 80.0, rtol=0.5, atol=0.1, return_info=True)
        assert info_t == info_j
    else:
        want = fn(jnp.asarray(x))
        t_x = nchw(x)
        if name == "dpm_fast":
            got = P.samplers.sample_dpm_fast(tden, t_x, 0.01, 80.0, 4)
        elif name == "dpmpp_2m_sde":
            got = P.samplers.sample_dpmpp_2m_sde(
                tden, t_x, sig_t,
                noise_sampler=tree_replay(key, sig_t.numpy(), shape))
        else:
            got = getattr(P.samplers, f"sample_{name}")(
                tden, t_x, sig_t,
                noise_sampler=draws(4 if "2" in name else 3, 1))
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 5e-5
