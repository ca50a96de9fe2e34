"""The port's training surface (`kdip_tpu_torch.train`, `.utils`,
`.tfevents`) against `kdip_tpu`'s: the four losses, the gradient of the
DWT-Var fine-tune loss with respect to every parameter, Adam / MultiSteps /
the EMA fed the same gradients, two whole train steps, per_sample_map
against the batched step, the sigma densities on `kdip_tpu`'s own draws,
the EMA and LR schedules, the analytic-variance table with injected noise
and its journal, and the TensorBoard event files both ways.

One tiny ADM V2 (32 px, 32 channels, channel_mult 1,2, one res block,
heads of 16 channels; tests/test_cli.py's sizes), float32, random weights
moved from flax through `weights.from_jax_params`. x0 is drawn with numpy;
sigma and noise with `kdip_tpu`'s keys, then injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import kdip_tpu_torch as P
from kdip_tpu import diffusion as jd
from kdip_tpu import precond as jprecond
from kdip_tpu import tfevents as jtfevents
from kdip_tpu import train as jtrain
from kdip_tpu import utils as jutils
from kdip_tpu.models import adm as jadm
from kdip_tpu.ops.transforms import OrthoTransform as JOrtho
from test_torch_port import (SMALL_UNET, nchw, one_torch_thread,  # noqa: F401
                             random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S, B = 32, 2
UNET = dict(SMALL_UNET, image_size=S)
LR = 1e-4
# configs/train_ffhq_dwt.json's density and EMA warmup
DENSITY_CFG = {"sigma_sample_density": {"type": "cosine"}}
SIGMA_DATA, SIGMA_MIN, SIGMA_MAX = 0.5, 1e-2, 80.0
EMA = dict(power=0.6667, max_value=0.9999)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _torch_named(tree):
    """A {"unet", "out_cov"} tree (params, grads or Adam moments) under the
    port's parameter names."""
    return P.weights.from_jax_params(_np_tree(tree))


@pytest.fixture(scope="module")
def env():
    """The tiny V2 model on both sides, the tables, a batch, kdip_tpu's
    sigma and noise for it, its loss and gradient there, and its two
    train steps."""
    jm = jadm.ADMUNetV2(unet=jadm.ADMUNet(**UNET))
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=3)
    tm = P.adm.ADMUNetV2(P.adm.ADMUNet(**UNET, device="cpu"))
    tm.load_state_dict(P.weights.from_jax_params(params))
    jlog = jd.make_diffusion(1000, "linear").log_sigmas
    tlog = P.diffusion.make_diffusion(1000, "linear", device="cpu").log_sigmas
    density = jutils.make_sample_density(DENSITY_CFG, SIGMA_DATA, SIGMA_MIN,
                                         SIGMA_MAX)
    x0 = np.random.RandomState(0).uniform(-1, 1, (B, S, S, 3)).astype(
        np.float32)

    def apply_v2(p, x, t):
        return jm.apply({"params": p}, x, t, deterministic=True)

    def loss_fn(p, x, noise, sigma):
        return jtrain.openai_v2_loss(apply_v2, p, x, noise, sigma, jlog,
                                     JOrtho("dwt"))

    def draws(key):
        """The sigma and noise that kdip_tpu's step draws from `key`
        (train.py:110-112)."""
        k_sigma, k_noise = jax.random.split(key)
        return (density(k_sigma, (B,)),
                jax.random.normal(k_noise, (B, S, S, 3), jnp.float32))

    # kdip_tpu's jitted step twice at accum 2 (optax.MultiSteps): after the
    # first call its accumulator, the running mean of one gradient, is
    # that gradient exactly; the second call takes the Adam step. One
    # compile serves the gradient, the loss and the end-to-end tests.
    opt = optax.MultiSteps(optax.adam(LR), 2)
    jstep = jax.jit(jtrain.make_train_step(loss_fn, opt, density))
    jstate = jax.jit(lambda p: jtrain.create_train_state(p, opt))(params)
    sched = jutils.EMAWarmup(**EMA)
    states, losses, decays = [], [], []
    for seed in (5, 6):
        decays.append(sched.get_value())
        jstate, m = jstep(jstate, jnp.asarray(x0), jax.random.key(seed),
                          decays[-1])
        sched.step()
        states.append(jstate)
        losses.append(float(m["loss"]))
    sigma, noise = draws(jax.random.key(5))
    grads = _np_tree(states[0].opt_state.acc_grads)
    named = _torch_named(grads)
    top = max(float(g.abs().max()) for g in named.values())
    # the conv biases right before a GroupNorm of one channel a group (the
    # 32-channel ResBlocks' in_layers.2): the norm removes them, so their
    # gradient is 0 and either side's is rounding noise (~1e-7 of the
    # largest gradient element; the next smallest tensor's is ~1e-3)
    null = {k for k, g in named.items() if float(g.abs().max()) < 1e-6 * top}
    assert len(null) == 4, sorted(null)
    yield dict(jm=jm, params=params, tm=tm, jlog=jlog, tlog=tlog,
               x0=x0, draws=draws, sigma=sigma, noise=noise,
               loss=losses[0], grads=grads, named_grads=named, top=top,
               null=null, states=states, losses=losses, decays=decays)


def _port_loss_fn(model, tlog):
    return lambda x, noise, sigma: P.train.openai_v2_loss(
        model, x, noise, sigma, tlog, P.transforms.OrthoTransform("dwt"))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

def _closed_form_models():
    """A smooth stand-in network per loss on each side (the three losses
    beside openai_v2_loss differ only in their scalings and targets): an
    output, and for the variance loss two log-variances."""
    def j_out(x, s):
        return jnp.tanh(x) * 0.7 + x * jprecond.append_dims(s, x.ndim) * 0.1

    def t_out(x, s):
        return (torch.tanh(x) * 0.7
                + x * P.schedules.append_dims(s, x.ndim) * 0.1)
    return {
        "edm": (lambda p, x, s: j_out(x, s), t_out),
        "simple": (lambda p, x, s: x / (1 + jprecond.append_dims(s, 4) ** 2)
                   + 0.1 * jnp.sin(x),
                   lambda x, s: x / (1 + P.schedules.append_dims(s, 4) ** 2)
                   + 0.1 * torch.sin(x)),
        "variance": (lambda p, x, s: (j_out(x, s), 0.2 * x, -0.3 * x),
                     lambda x, s: (t_out(x, s), 0.2 * x, -0.3 * x)),
    }


@pytest.mark.parametrize("name", ["edm", "simple", "variance", "openai_v2"])
def test_losses_match(env, name):
    """Per-example losses on the same x0, noise and sigma within 1e-5
    relative, for openai_v2 (through the UNet) the batch mean that
    kdip_tpu's step reports: float32 on both sides, the DWT basis for the
    two dual-NLL losses (measured: at most 2e-7 with the stand-in
    networks, ~1e-7 for openai_v2)."""
    x0, noise, sigma = jnp.asarray(env["x0"]), env["noise"], env["sigma"]
    tx0, tnoise, tsigma = nchw(env["x0"]), nchw(noise), _t(sigma)
    if name == "openai_v2":
        # kdip_tpu's step reports the batch mean
        want = [env["loss"]]
        with torch.no_grad():
            got = _port_loss_fn(env["tm"], env["tlog"])(tx0, tnoise, tsigma)
        assert got.shape == (B,)
        got = got.mean(0, keepdim=True)
    else:
        jf, tf = _closed_form_models()[name]
        kw, tkw = {}, {}
        if name != "simple":
            kw, tkw = {"sigma_data": SIGMA_DATA}, {"sigma_data": SIGMA_DATA}
        if name == "variance":
            kw["ortho_tf"], tkw["ortho_tf"] = (
                JOrtho("dwt"), P.transforms.OrthoTransform("dwt"))
        want = jax.jit(lambda *a: getattr(jtrain, f"{name}_loss")(
            jf, None, *a, **kw))(x0, noise, sigma)
        got = getattr(P.train, f"{name}_loss")(tf, tx0, tnoise, tsigma, **tkw)
        assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _assert_grads_close(got, env, rtol_of_max, what=""):
    """Each gradient tensor within rtol_of_max of its largest element in
    env's (kdip_tpu's) gradient; the tensors whose gradient is 0 in exact
    arithmetic (env["null"]) within 1e-6 of the model's largest."""
    assert set(got) == set(env["named_grads"])
    for k, g in got.items():
        w = env["named_grads"][k].numpy()
        atol = (1e-6 * env["top"] if k in env["null"]
                else rtol_of_max * np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


def test_openai_v2_gradient_matches_for_every_parameter(env):
    """The batch-mean loss and its gradient with respect to every
    parameter (torso and out_cov head) against jax.value_and_grad: the
    loss within 1e-6 relative, each gradient tensor within 1e-4 of its
    largest element (float32 backward passes through 30 layers summing in
    other orders; measured at most 1.5e-5), through the DWT's adjoint. The
    four tensors whose gradient is 0 in exact arithmetic (see env) are held
    to 1e-6 of the model's largest gradient element."""
    tm = env["tm"]
    tm.zero_grad(set_to_none=True)
    loss = _port_loss_fn(tm, env["tlog"])(
        nchw(env["x0"]), nchw(env["noise"]), _t(env["sigma"])).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), env["loss"], rtol=1e-6)
    _assert_grads_close({k: p.grad for k, p in tm.named_parameters()}, env,
                        1e-4)
    tm.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# the optimizer, the EMA, whole steps
# ---------------------------------------------------------------------------

def _fresh_port_model(params):
    tm = P.adm.ADMUNetV2(P.adm.ADMUNet(**UNET, device="cpu"))
    tm.load_state_dict(P.weights.from_jax_params(params))
    return tm


def _assert_tree_close(tree, named, rtol, atol, what):
    want = _torch_named(tree)
    for k, v in named.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("accum,calls", [(1, 3), (2, 4)])
def test_optimizer_and_ema_given_the_same_gradients(env, accum, calls):
    """Fed kdip_tpu's gradient, scaled differently at each call, both
    sides take the same Adam (optax.adam, and MultiSteps' running mean at
    accum 2: Adam on calls 2 and 4 only) and EMA (EMAWarmup's decays, on
    every call) steps: parameters and EMA within 1e-6 relative plus 1e-4
    of lr (float32 on both sides, torch's Adam dividing by sqrt(bias
    correction) where optax divides nu first: measured 1.2e-9 where the
    gradient is near 0 and sqrt(nu) meets eps), Adam moments within 1e-6
    relative. kdip_tpu's side runs on the raveled parameter vector (every
    operation is elementwise, so the arithmetic is the same, and one small
    program compiles)."""
    flat, unravel = ravel_pytree(env["params"])
    flat_g = ravel_pytree(env["grads"])[0]
    opt = optax.adam(LR)
    if accum > 1:
        opt = optax.MultiSteps(opt, accum)

    @jax.jit
    def jax_call(jstate, g, decay):
        """kdip_tpu's step after its gradient (train.py:145-150)."""
        updates, opt_state = opt.update(g, jstate.opt_state, jstate.params)
        p_new = optax.apply_updates(jstate.params, updates)
        return jtrain.TrainState(
            step=jstate.step + 1, params=p_new, opt_state=opt_state,
            ema_params=jutils.ema_update(jstate.ema_params, p_new, decay))

    jstate = jax.jit(lambda p: jtrain.create_train_state(p, opt))(flat)
    tm = _fresh_port_model(env["params"])
    state = P.train.TrainState(tm, LR, accum)
    sched = P.utils.EMAWarmup(**EMA)
    names = [k for k, _ in tm.named_parameters()]
    for call, c in enumerate([1.0, -0.5, 2.0, 0.25][:calls]):
        decay = sched.get_value()
        jstate = jax_call(jstate, flat_g * c, decay)
        for k, p in zip(names, state.params):
            p.grad = env["named_grads"][k] * c
        state.apply_gradients(decay)
        sched.step()
        assert state.mini_step == (call + 1) % accum
    assert state.step == calls
    _assert_tree_close(unravel(jstate.params), dict(tm.named_parameters()),
                       1e-6, 1e-4 * LR, "params")
    _assert_tree_close(unravel(jstate.ema_params),
                       dict(state.ema.named_parameters()), 1e-6, 1e-4 * LR,
                       "ema")
    adam = (jstate.opt_state.inner_opt_state if accum > 1
            else jstate.opt_state)[0]
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        _assert_tree_close(unravel(moment),
                           {k: state.optimizer.state[p][key]
                            for k, p in zip(names, state.params)},
                           1e-6, 1e-12, key)
    assert int(adam.count) == calls // accum


def test_two_train_steps_end_to_end(env):
    """kdip_tpu's jitted make_train_step twice at accum 2 (the fixture's:
    the EMA moves on both calls, Adam steps on the second with the mean of
    the two gradients) against the port's step fed the same sigma and
    noise (drawn from kdip_tpu's step keys): losses within 1e-6 relative;
    after the first call the accumulator within 1e-4 of each tensor's
    largest element; after the second the parameters and EMA within 2% of
    lr, except where the mean gradient is 0 in exact arithmetic
    (env["null"]) or under 1e-3 of its tensor's largest element: Adam's
    first update is about lr * sign(g) wherever |g| >> eps, so a near-zero
    gradient whose sign the two float32 backward passes round differently
    moves 2 lr apart. The exempt elements are under 1% of the
    parameters."""
    tm = _fresh_port_model(env["params"])
    state = P.train.TrainState(tm, LR, accum=2)
    tstep = P.train.make_train_step(_port_loss_fn(tm, env["tlog"]), None)
    for seed, decay, want_loss in zip((5, 6), env["decays"], env["losses"]):
        sigma, noise = env["draws"](jax.random.key(seed))
        loss = tstep(state, nchw(env["x0"]), decay, sigma=_t(sigma),
                     noise=nchw(noise))
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
        if seed == 5:
            _assert_grads_close(dict(zip(
                [k for k, _ in tm.named_parameters()], state.acc_grads)),
                env, 1e-4, "accumulator")
    jstate = env["states"][1]
    mean_g = _torch_named(jstate.opt_state.inner_opt_state[0].mu)
    want_p, want_e = (_torch_named(jstate.params),
                      _torch_named(jstate.ema_params))
    exempt = total = 0
    for (k, p), e in zip(tm.named_parameters(), state.ema.parameters()):
        g = np.abs(mean_g[k].numpy())
        keep = ((g >= 1e-3 * g.max()) if k not in env["null"]
                else np.zeros(g.shape, bool))
        exempt += int((~keep).sum())
        total += keep.size
        for got, want in ((p, want_p[k]), (e, want_e[k])):
            np.testing.assert_allclose(got.detach().numpy()[keep],
                                       want.numpy()[keep], rtol=0,
                                       atol=0.02 * LR, err_msg=k)
    assert exempt < 0.01 * total, (exempt, total)


def test_per_sample_map_gives_the_batched_step(env):
    """The per-example backward passes (loss_i / B into the same
    gradients) against one batched backward, before the update (read by a
    recording apply_gradients): the same loss within 1e-6 relative, and
    the same gradients within 1e-5 of each tensor's largest element (B = 2
    makes the 1/B scaling exact: only the summation order differs), the
    four whose gradient is 0 in exact arithmetic within 1e-6 of the
    model's largest; and both within 1e-4 of kdip_tpu's."""
    grads, losses = [], []
    for psm in (True, False):
        tm = _fresh_port_model(env["params"])
        state = P.train.TrainState(tm, LR)
        seen = {}
        state.apply_gradients = (lambda d, s=state, seen=seen: seen.update(
            {k: p.grad.clone() for k, p in s.model.named_parameters()}))
        step = P.train.make_train_step(_port_loss_fn(tm, env["tlog"]), None,
                                       per_sample_map=psm)
        losses.append(float(step(state, nchw(env["x0"]), 0.0,
                                 sigma=_t(env["sigma"]),
                                 noise=nchw(env["noise"]))))
        grads.append(seen)
        _assert_grads_close(seen, env, 1e-4, f"per_sample_map={psm}")
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    np.testing.assert_allclose(losses[0], env["loss"], rtol=1e-6)
    for k, g in grads[0].items():
        scale = float(grads[1][k].abs().max())
        atol = 1e-6 * env["top"] if k in env["null"] else 1e-5 * scale
        np.testing.assert_allclose(g.numpy(), grads[1][k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# densities and schedules
# ---------------------------------------------------------------------------

DENSITIES = {
    "lognormal": {"type": "lognormal", "mean": -1.2, "std": 1.2},
    "loglogistic": {"type": "loglogistic", "loc": -0.5, "scale": 0.6},
    "loguniform": {"type": "loguniform"},
    "cosine": {"type": "cosine"},
    "split-lognormal": {"type": "split-lognormal", "mean": -0.4,
                        "std_1": 0.8, "std_2": 1.6},
}


@pytest.mark.parametrize("name", list(DENSITIES))
def test_density_maps_kdip_tpus_draws(name):
    """make_sample_density's sigmas for 256 draws: the port's map from
    uniforms / normals to sigma, fed the draws kdip_tpu makes from the same
    key (uniforms in [0, 1): jax.random.uniform scales them to the cdf
    bounds in float32, as the map does), within 1e-5 relative (float32
    exp / tan / logit). The port's own draws, from a generator, land in
    the same support."""
    cfg = {"sigma_sample_density": DENSITIES[name]}
    key, shape = jax.random.key(7), (256,)
    want = np.asarray(jutils.make_sample_density(
        cfg, SIGMA_DATA, SIGMA_MIN, SIGMA_MAX)(key, shape))
    U = P.utils
    mn, mx = SIGMA_MIN, SIGMA_MAX
    if name == "lognormal":
        got = U.log_normal_from(_t(jax.random.normal(key, shape)), -1.2, 1.2)
    elif name == "split-lognormal":
        k1, k2, _ = jax.random.split(key, 3)
        got = U.split_log_normal_from(_t(jax.random.normal(k1, shape)),
                                      _t(jax.random.uniform(k2, shape)),
                                      -0.4, 0.8, 1.6)
    else:
        u = _t(jax.random.uniform(key, shape))
        got = {"loglogistic": lambda: U.log_logistic_from(u, -0.5, 0.6, mn,
                                                          mx),
               "loguniform": lambda: U.log_uniform_from(u, mn, mx),
               "cosine": lambda: U.v_diffusion_from(u, SIGMA_DATA, mn, mx),
               }[name]()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    own = U.make_sample_density(cfg, SIGMA_DATA, SIGMA_MIN, SIGMA_MAX)(
        shape, torch.Generator().manual_seed(0))
    assert own.shape == shape and own.dtype == torch.float32
    assert (own > 0).all() and torch.isfinite(own).all()
    if name in ("loglogistic", "loguniform", "cosine"):
        assert (own >= mn * (1 - 1e-6)).all() and (own <= mx * 1.0001).all()


def test_ema_warmup_and_lr_schedules():
    """EMAWarmup at steps 0-5 and 1000 (train_ffhq_dwt.json's power and
    max, and defaults) equals kdip_tpu's; InverseLR and ExponentialLR with
    warmup and a floor within float32 rounding (kdip_tpu's are jnp)."""
    for kw in (EMA, {}):
        js, ts = jutils.EMAWarmup(**kw), P.utils.EMAWarmup(**kw)
        for step in range(1001):
            if step <= 5 or step == 1000:
                assert ts.get_value() == js.get_value(), (kw, step)
            js.step()
            ts.step()
    for jf, tf in ((jutils.inverse_lr(2.0, 0.7, 0.9, 0.05),
                    P.utils.inverse_lr(2.0, 0.7, 0.9, 0.05)),
                   (jutils.exponential_lr(100, 0.5, 0.99, 0.1),
                    P.utils.exponential_lr(100, 0.5, 0.99, 0.1))):
        for step in (0, 1, 5, 50, 1000):
            np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6)


def test_csv_logger_writes_its_columns_once(tmp_path):
    """CSVLogger, as kdip_tpu's: a new file starts with the column row, a
    second logger on the same file appends without it; each row is
    comma-separated and flushed."""
    path = tmp_path / "log.csv"
    for rows in ([(1, 2.5)], [(2, 0.125), (3, 0.0625)]):
        tlog = P.utils.CSVLogger(path, ["step", "loss"])
        for row in rows:
            tlog.write(*row)
        tlog.close()
        jlog = jutils.CSVLogger(tmp_path / "j.csv", ["step", "loss"])
        for row in rows:
            jlog.write(*row)
        jlog.file.close()
    assert path.read_text() == "step,loss\n1,2.5\n2,0.125\n3,0.0625\n"
    assert path.read_text() == (tmp_path / "j.csv").read_text()


# ---------------------------------------------------------------------------
# the analytic-variance table
# ---------------------------------------------------------------------------

def _denoisers(env):
    jm, tm = env["jm"], env["tm"]
    jden = jprecond.make_discrete_eps_denoiser(
        lambda p, x, t: jm.apply({"params": p}, x, jnp.broadcast_to(
            jnp.asarray(t, jnp.float32), (x.shape[0],)))[0], env["jlog"])
    tden = P.precond.make_discrete_eps_denoiser(lambda x, t: tm(x, t)[0],
                                                env["tlog"])
    return jden, tden


def test_analytic_variance_matches_and_resumes(env, tmp_path):
    """kdip_tpu's analytic_variance and the port's over 2 batches of 2 and
    3 Karras sigmas, the port fed kdip_tpu's noise for sigma i and batch j
    (fold_in(fold_in(key, i), j)) through noise_fn: mse within 1e-5
    relative (float32 means of float32 UNet outputs), err (the population
    std, jnp.std's, over sqrt(2)) within 1e-5 of the mse. Then a journal:
    a rerun reads every sigma back with 0 denoiser calls and an identical
    table, and a journal from another grid is refused."""
    jden, tden = _denoisers(env)
    rng = np.random.RandomState(1)
    jb = [rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
          for _ in range(2)]
    sigmas = P.schedules.get_sigmas_karras(4, SIGMA_MIN,
                                           SIGMA_MAX).numpy()[:-1]
    key = jax.random.key(11)
    want = jtrain.analytic_variance(jden, jb, sigmas, key,
                                    params=env["params"])

    def noise_fn(i, j, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, i), j)
        return nchw(jax.random.normal(k, jb[j].shape, jnp.float32))

    journal = str(tmp_path / "recon_mse.jsonl")
    tb = [nchw(b) for b in jb]
    with torch.no_grad():
        got = P.train.analytic_variance(tden, tb, sigmas, 0,
                                        journal_path=journal,
                                        noise_fn=noise_fn)
    np.testing.assert_array_equal(got["sigmas"].numpy(), want["sigmas"])
    mse = np.asarray(want["mse_list"])
    np.testing.assert_allclose(got["mse_list"].numpy(), mse, rtol=1e-5)
    # err is |mse_0 - mse_1| / 2 / sqrt(2): its rounding is the mses'
    err_diff = np.abs(got["errors"].numpy() - np.asarray(want["errors"]))
    assert (err_diff <= 1e-5 * mse).all(), err_diff / mse
    calls = []

    def counting(x, s):
        calls.append(s)
        return tden(x, s)
    again = P.train.analytic_variance(counting, tb, sigmas, 0,
                                      journal_path=journal)
    assert calls == []
    for k in got:
        assert torch.equal(again[k], got[k]), k
    with pytest.raises(SystemExit, match="use a fresh journal"):
        P.train.analytic_variance(counting, tb, sigmas * 1.5, 0,
                                  journal_path=journal)


def test_tfevents_read_both_ways(tmp_path):
    """The port's EventFileWriter is read by kdip_tpu's read_events and
    kdip_tpu's by the port's: the same tags, steps and float32 values (a
    file-version event first)."""
    rows = [(1, [("train/loss", 2.5), ("train/ema_decay", 0.0)]),
            (50, [("train/loss", 0.125), ("train/ema_decay", 0.9375)])]
    for writer, reader, sub in ((P.tfevents, jtfevents, "port"),
                                (jtfevents, P.tfevents, "jax")):
        w = writer.EventFileWriter(str(tmp_path / sub))
        for step, vals in rows:
            w.add_scalars(step, vals)
        w.close()
        events = reader.read_events(w.path)
        assert len(events) == 1 + len(rows)
        assert [(s, v) for _, s, v in events[1:]] == [
            (s, dict(v)) for s, v in rows]
