"""The port's guided-diffusion training surface (`kdip_tpu_torch.train_loop`,
`.resample`, `.gns`, `.logger`, `ddpm_sampling.training_losses`) against
`kdip_tpu`'s, on the CPU.

`training_losses` on a closed-form model with the noise injected; the
schedule samplers from one RandomState; the GNS estimator and the logger's
files fed the same calls; and the whole TrainLoop: a small ADM UNet (16 px,
64 channels, so that no GroupNorm group is one channel, whose conv bias has
a zero gradient), float32, 3 steps at batch 4 in microbatches of 2, fed
`kdip_tpu`'s q-sample noise (its `jax.random.split` chain replayed here)
through `noise_fn`. kdip_tpu's TrainLoop jits per instance, so it runs once,
in a module-scoped fixture. Then the bf16 Winograd torso's parameter
gradients (float32 masters, the plain kernels) against kdip_tpu's (float32
params, bf16 compute, the Pallas kernel in interpret mode), and the loop's
checkpoints, resume, DIFFUSION_TRAINING_TEST, lr annealing and AdamW.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import ddpm_sampling as jddpm
from kdip_tpu import diffusion as jd
from kdip_tpu import gns as jgns
from kdip_tpu import logger as jlogger
from kdip_tpu import resample as jresample
from kdip_tpu.models import adm as jadm
from kdip_tpu.train_loop import TrainLoop as JTrainLoop
from test_torch_port import (SMALL_UNET, nchw, nhwc,  # noqa: F401
                             one_torch_thread, random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = SMALL_UNET["image_size"]
UNET = dict(SMALL_UNET, model_channels=64)
SEED, LR, STEPS, B, MB = 3, 1e-4, 3, 4, 2
EMA = "0.5,0.9"


# ---------------------------------------------------------------------------
# training_losses
# ---------------------------------------------------------------------------

def _closed_form(out_ch, seed=0):
    """The same model on both sides: a channel mix of x, scaled by t,
    through tanh (so the variance values lie in (-1, 1))."""
    w = np.random.default_rng(seed).standard_normal(
        (3, out_ch)).astype(np.float32) * 0.5

    def jf(x, t):
        s = 1 + t.astype(jnp.float32)[:, None, None, None] / 1000
        return jnp.tanh(jnp.einsum("bhwc,cd->bhwd", x, w) * s)

    def tf(x, t):
        s = 1 + t.to(torch.float32)[:, None, None, None] / 1000
        return torch.tanh(torch.einsum("bchw,cd->bdhw", x,
                                       torch.from_numpy(w)) * s)
    return jf, tf


@pytest.mark.parametrize("predict_xstart", [False, True])
@pytest.mark.parametrize("learn_sigma", [True, False])
@pytest.mark.parametrize("loss_type",
                         ["mse", "rescaled_mse", "kl", "rescaled_kl"])
def test_training_losses_match(loss_type, learn_sigma, predict_xstart):
    """Every term, float32 on both sides, within 1e-5 relative to its
    largest value (t = 0 takes the decoder NLL, the rest the KL); without
    learn_sigma also with sigma_small. One exception: under predict_xstart
    the decoder NLL at t = 0 is a float32 cancellation (x_start minus a
    tanh output, over a std of ~0.01, through differences of CDFs near 0
    and 1), so each side's float32 value departs from a float64 evaluation
    of the same formula: by 0.17% here and 0.61% in kdip_tpu (measured,
    mse with learn_sigma). That element is held within 1e-2 relative."""
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 1, 499, 999], np.int32)
    jtab = jd.make_diffusion(1000, "linear")
    ttab = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    jf, tf = _closed_form(6 if learn_sigma else 3)
    for sigma_small in ((False,) if learn_sigma else (False, True)):
        kw = dict(loss_type=loss_type, learn_sigma=learn_sigma,
                  predict_xstart=predict_xstart, sigma_small=sigma_small)
        want = jddpm.training_losses(jtab, jf, jnp.asarray(x0),
                                     jnp.asarray(t), None,
                                     noise=jnp.asarray(noise), **kw)
        got = P.ddpm_sampling.training_losses(
            ttab, tf, nchw(x0), torch.from_numpy(t).long(),
            noise=nchw(noise), **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            w, g = np.asarray(want[k]), got[k].numpy()
            if predict_xstart and k != "mse":
                np.testing.assert_allclose(g[t == 0], w[t == 0], rtol=1e-2)
                g, w = g[t != 0], w[t != 0]
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()))


def test_training_losses_draws_noise_from_generator():
    """Without noise=, the q-sample noise is a normal draw from the
    generator: the same seed, the same loss."""
    ttab = P.diffusion.make_diffusion(1000, "linear", device="cpu")
    _, tf = _closed_form(6)
    x0 = torch.rand(2, 3, 8, 8) * 2 - 1
    t = torch.tensor([3, 700])
    a, b = (P.ddpm_sampling.training_losses(
        ttab, tf, x0, t, torch.Generator().manual_seed(4))["loss"]
        for _ in range(2))
    assert torch.equal(a, b)
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(4))
    c = P.ddpm_sampling.training_losses(ttab, tf, x0, t, noise=noise)["loss"]
    assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# resample, gns, logger
# ---------------------------------------------------------------------------

def test_schedule_samplers_draw_alike():
    """t and the weights bit-equal from one RandomState seed, before the
    loss-aware sampler warms up and after; the loss history equal after
    the same updates."""
    for name in ("uniform", "loss-second-moment"):
        js = jresample.create_named_schedule_sampler(name, 20)
        ts = P.resample.create_named_schedule_sampler(name, 20)
        assert type(ts).__name__ == type(js).__name__
        jr, tr = np.random.RandomState(5), np.random.RandomState(5)
        upd = np.random.default_rng(6)
        for _ in range(30):
            jt, jw = js.sample(8, jr)
            tt, tw = ts.sample(8, tr)
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_array_equal(tw, jw)
            assert tt.dtype == jt.dtype and tw.dtype == jw.dtype
            if name != "uniform":
                losses = upd.random(8).astype(np.float32)
                js.update_with_local_losses(jt, losses)
                ts.update_with_local_losses(tt, losses)
                np.testing.assert_array_equal(ts._loss_history,
                                              js._loss_history)
                np.testing.assert_array_equal(ts._loss_counts,
                                              js._loss_counts)
        if name != "uniform":
            ts_all = np.repeat(np.arange(20), 10)
            losses = upd.random(ts_all.size).astype(np.float32)
            js.update_with_all_losses(ts_all, losses)
            ts.update_with_all_losses(ts_all, losses)
            assert ts._warmed_up() and js._warmed_up()
            np.testing.assert_array_equal(ts.weights(), js.weights())
            for _ in range(5):
                np.testing.assert_array_equal(ts.sample(8, tr)[0],
                                              js.sample(8, jr)[0])
    with pytest.raises(NotImplementedError):
        P.resample.create_named_schedule_sampler("nope", 10)


def test_gradient_noise_scale_equal_floats():
    j, t = jgns.GradientNoiseScale(), P.gns.GradientNoiseScale()
    rng = np.random.default_rng(7)
    for _ in range(5):
        small, big = rng.random() * 2 + 1, rng.random()
        assert t.update(small, big, 2, 8) == j.update(small, big, 2, 8)
        assert t.get_stats() == j.get_stats()
        assert t.get_gns() == j.get_gns()


def _log_session(lg, d):
    """The same calls into kdip_tpu's logger or the port's, in dir d."""
    with lg.scoped_configure(dir=d, format_strs=["log", "json", "csv"]):
        lg.logkv("step", 1)
        lg.logkv_mean("loss", 0.5)
        lg.logkv_mean("loss", 0.25)
        lg.logkv("a_very_long_key_name_that_gets_truncated", 1.0 / 3)
        lg.log("a message", 3)
        lg.dumpkvs()
        lg.logkv("step", 2)
        lg.logkv("gns", 12.5)   # a new column: the CSV rewrites its header
        lg.logkv("name", "text")
        lg.get_current().set_level(lg.WARN)
        lg.log("hidden")
        lg.warn("shown")
        lg.get_current().set_level(lg.INFO)
        with lg.profile_kv("io"):
            pass
        out = lg.dumpkvs()
    return {"wait_io" in out,
            *(k for k in out if k != "wait_io")}


def test_logger_files_byte_equal(tmp_path):
    """log.txt, progress.json and progress.csv byte for byte (the wait_
    value is a time, so the profiled key is checked, then dropped from
    both), written into the same directory one after the other."""
    d = str(tmp_path / "log")
    files = {}
    for name, lg in (("jax", jlogger), ("port", P.logger)):
        keys = _log_session(lg, d)
        assert True in keys
        files[name] = {}
        for f in ("log.txt", "progress.json", "progress.csv"):
            with open(os.path.join(d, f), "rb") as fh:
                files[name][f] = fh.read()
            os.remove(os.path.join(d, f))
    for f, data in files["port"].items():
        lines_p = [ln for ln in data.split(b"\n") if b"wait_io" not in ln]
        lines_j = [ln for ln in files["jax"][f].split(b"\n")
                   if b"wait_io" not in ln]
        if f == "progress.json":
            lines_p = [json.dumps({k: v for k, v in json.loads(ln).items()
                                   if k != "wait_io"}).encode()
                       for ln in data.split(b"\n") if ln]
            lines_j = [json.dumps({k: v for k, v in json.loads(ln).items()
                                   if k != "wait_io"}).encode()
                       for ln in files["jax"][f].split(b"\n") if ln]
        if f == "progress.csv":
            # the wait_io column's values are times: drop the column
            def drop(raw):
                rows = [r.split(b",") for r in raw.split(b"\n") if r]
                i = rows[0].index(b"wait_io")
                return [b",".join(c for j, c in enumerate(r) if j != i)
                        for r in rows]
            lines_p, lines_j = drop(data), drop(files["jax"][f])
        assert lines_p == lines_j, f
    assert b"shown" in files["port"]["log.txt"]
    assert b"hidden" not in files["port"]["log.txt"]


def test_logger_tensorboard_scalars_read_back(tmp_path):
    """The tensorboard format writes each dump's numeric values at its
    'step', through the port's EventFileWriter; read_events gets them
    back."""
    d = str(tmp_path / "tb")
    with P.logger.scoped_configure(dir=d, format_strs=["tensorboard"]):
        for s in (1, 2):
            P.logger.logkv("step", s)
            P.logger.logkv_mean("loss", 0.5 / s)
            P.logger.logkv("note", "not a number")
            P.logger.dumpkvs()
    tb = os.path.join(d, "tb")
    (path,) = [os.path.join(tb, f) for f in os.listdir(tb)]
    events = [e for e in P.tfevents.read_events(path) if e[2]]
    assert [(e[1], e[2]) for e in events] == [
        (1, {"loss": pytest.approx(0.5), "step": 1.0}),
        (2, {"loss": pytest.approx(0.25), "step": 2.0})]


# ---------------------------------------------------------------------------
# TrainLoop against kdip_tpu's
# ---------------------------------------------------------------------------

def _batches():
    rng = np.random.RandomState(0)
    return [rng.rand(B, S, S, 3).astype(np.float32) * 2 - 1
            for _ in range(STEPS)]


def _jax_noise(seed, n):
    """kdip_tpu's TrainLoop noise, by replaying its key chain: one split
    per microbatch, normal of the microbatch's NHWC shape."""
    key, out = jax.random.key(seed), []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (MB, S, S, 3),
                                                jnp.float32)))
    return out


def _read_json_log(d):
    with open(os.path.join(d, "progress.json")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """kdip_tpu's TrainLoop, once: float32 params, 3 steps, GNS on, the
    loss-second-moment sampler, two EMAs; its params, EMAs and logs."""
    jm = jadm.ADMUNet(**UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=4)

    def model_fn(p, x, t):
        return jm.apply({"params": p}, x, t.astype(jnp.float32))

    d = str(tmp_path_factory.mktemp("jax_loop"))
    with jlogger.scoped_configure(dir=os.path.join(d, "log"),
                                  format_strs=["json"]):
        loop = JTrainLoop(
            model_fn=model_fn, params=params,
            tables=jd.make_diffusion(1000, "linear"), data=iter(_batches()),
            batch_size=B, microbatch=MB, lr=LR, ema_rate=EMA,
            log_interval=1, save_interval=100, logdir=os.path.join(d, "ck"),
            schedule_sampler=jresample.LossSecondMomentResampler(1000),
            loss_type="rescaled_mse", resume=False, seed=SEED,
            measure_gns=True)
        loop.run_loop(max_steps=STEPS)
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    # the first microbatch's draws and gradient, through the loop's jitted
    # function: t from RandomState(SEED), the noise from the first split
    t, w = jresample.LossSecondMomentResampler(1000).sample(
        MB, np.random.RandomState(SEED))
    _, k = jax.random.split(jax.random.key(SEED))
    _, _, g = loop._micro_grad(params, jnp.asarray(_batches()[0][:MB]),
                               jnp.asarray(t), jnp.asarray(w), k)
    return {"init": params, "grad0": np_tree(g), "t0": t, "w0": w, "params": np_tree(loop.params),
            "emas": [np_tree(e) for e in loop.ema_params],
            "log": _read_json_log(os.path.join(d, "log")),
            "counts": loop.schedule_sampler._loss_counts.copy()}


def _port_loop(params, tmp, **kw):
    tm = P.adm.ADMUNet(**UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    noise = _jax_noise(SEED, STEPS * (B // MB))
    args = dict(model=tm, tables=P.diffusion.make_diffusion(
        1000, "linear", device="cpu"), data=iter(map(nchw, _batches())),
        batch_size=B, microbatch=MB, lr=LR, ema_rate=EMA, log_interval=1,
        save_interval=100, logdir=os.path.join(tmp, "ck"),
        schedule_sampler=P.resample.LossSecondMomentResampler(1000),
        loss_type="rescaled_mse", resume=False, seed=SEED, measure_gns=True,
        noise_fn=lambda step, i: nchw(noise[step * (B // MB) + i]))
    args.update(kw)
    return P.train_loop.TrainLoop(**args)


def _assert_params_close(sd, tree, what):
    """Within 1e-6 relative plus 1e-4 of lr (float32 on both sides; PR 11's
    bound for Adam fed one gradient), save for at most 0.1% of the
    elements, and every element within 1e-6 relative plus 1 lr. Adam
    divides each gradient by its own RMS, so where an element's gradient
    is near 0 the frameworks' ~1e-6 relative gradient differences (their
    conv and reduction orders) become a different step: measured, 0.063%
    of the elements past 1e-4 of lr after 3 steps, the worst at 0.45 lr
    (params; 0.39 lr in the EMAs)."""
    want = P.weights.from_jax_params(tree)
    assert sorted(sd) == sorted(want)
    beyond = total = 0
    for k, w in want.items():
        d = (sd[k].detach() - w).abs() - 1e-6 * w.abs()
        assert float(d.max()) <= LR, f"{what}: {k}"
        beyond += int((d > 1e-4 * LR).sum())
        total += w.numel()
    assert beyond <= 1e-3 * total, (what, beyond, total)


def test_train_loop_matches_kdip_tpu(jax_run, tmp_path):
    """Params and both EMAs after 3 steps as _assert_params_close holds
    them, and the first microbatch's gradient of every parameter within
    1e-5 of each tensor's largest element; each logged
    loss, mse and vb within 1e-5 relative, step and samples equal, gns
    within 1e-3 relative (a difference of two nearly equal squared norms
    over the summed parameters); the sampler's history counts equal."""
    d = str(tmp_path / "log")
    with P.logger.scoped_configure(dir=d, format_strs=["json"]):
        loop = _port_loop(jax_run["init"], str(tmp_path))
        loop.run_loop(max_steps=STEPS)
    assert loop.step == STEPS
    _assert_params_close(loop.model.state_dict(), jax_run["params"],
                         "params")
    for ema, want in zip(loop.ema_models, jax_run["emas"]):
        _assert_params_close(ema.state_dict(), want, "ema")
    np.testing.assert_array_equal(loop.schedule_sampler._loss_counts,
                                  jax_run["counts"])
    fresh = _port_loop(jax_run["init"], str(tmp_path / "fresh"))
    noise0 = nchw(_jax_noise(SEED, 1)[0])
    _, _, grads = fresh.micro_grads(
        nchw(_batches()[0][:MB]), torch.from_numpy(jax_run["t0"]).long(),
        torch.from_numpy(jax_run["w0"]), noise0)
    want_g = P.weights.from_jax_params(jax_run["grad0"])
    for (name, _), g in zip(fresh.model.named_parameters(), grads):
        ref = want_g[name]
        assert float((g - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max()), name
    got, want = _read_json_log(d), jax_run["log"]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["gns", "loss", "mse", "samples",
                                          "step", "vb"]
        assert (g["step"], g["samples"]) == (w["step"], w["samples"])
        for k in ("loss", "mse", "vb"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
        assert np.isfinite(g["gns"])
        assert g["gns"] == pytest.approx(w["gns"], rel=1e-3)
    # the saved float32 masters load strictly into the CLIs' ADMUNet
    path = os.path.join(str(tmp_path), "ck", f"model_{STEPS}.pt")
    P.ckpt.load_strict(P.adm.ADMUNet(**UNET, device="cpu"),
                       P.ckpt.load_torch_checkpoint(path))


def test_bf16_winograd_torso_gradients(tmp_path):
    """One microbatch's loss and the gradient of every float32 master
    through the port's bf16 Winograd torso (precast copy, the plain
    kernels on the CPU, fused where no dropout is live), against the same
    loop's float32 gradient and against kdip_tpu's float32 params through
    its bf16 Winograd torso (the Pallas kernel and its custom VJPs in
    interpret mode). Bound: the bf16 torso drift of
    test_torch_unet.py::test_unet_bf16_torso_drift, 0.1 of each gradient
    tensor's largest element, from the float32 gradient (measured 0.088;
    kdip_tpu's 0.078, its direct torso's 0.095); so the two bf16 torsos
    agree within 0.2 (measured 0.119, median over the tensors 0.049). The
    loss within 1e-2 relative of kdip_tpu's (measured 5e-4)."""
    jm = jadm.ADMUNet(**UNET, dtype=jnp.bfloat16, winograd=True)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=5)
    rng = np.random.default_rng(8)
    x0 = rng.uniform(-1, 1, (MB, S, S, 3)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([10, 600], np.int32)
    w = np.array([1.0, 0.5], np.float32)
    jtab = jd.make_diffusion(1000, "linear")

    def loss_fn(p):
        terms = jddpm.training_losses(
            jtab, lambda x, tt: jm.apply({"params": p}, x,
                                         tt.astype(jnp.float32)),
            jnp.asarray(x0), jnp.asarray(t), None, loss_type="rescaled_mse",
            noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"] * w)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)

    def port_grads(dtype):
        tm = P.adm.ADMUNet(**UNET, device="cpu", winograd=True)
        tm.load_state_dict(P.weights.from_jax_params(params))
        loop = P.train_loop.TrainLoop(
            model=tm, tables=P.diffusion.make_diffusion(1000, "linear",
                                                        device="cpu"),
            data=iter(()), batch_size=MB, loss_type="rescaled_mse",
            resume=False, logdir=str(tmp_path), compute_dtype=dtype)
        assert loop.compute.dtype == dtype and tm.dtype == torch.float32
        loop._sync_compute()
        loss, _, grads = loop.micro_grads(
            nchw(x0), torch.from_numpy(t).long(), torch.from_numpy(w),
            nchw(noise))
        assert all(g.dtype == torch.float32 for g in grads)
        return float(loss), dict(zip([n for n, _ in tm.named_parameters()],
                                     grads))
    counts = {"plain": 0, "fused": 0}
    run = P.ops.winograd._run

    def counting(x, v, prologue=None):
        counts["plain" if prologue is None else "fused"] += 1
        return run(x, v, prologue)
    P.ops.winograd._run = counting
    try:
        loss, grads = port_grads(torch.bfloat16)
    finally:
        P.ops.winograd._run = run
    assert counts["fused"] > 0 and counts["plain"] > 0
    _, ref = port_grads(torch.float32)
    assert abs(loss - float(jloss)) <= 1e-2 * abs(float(jloss))
    want = P.weights.from_jax_params(jax.tree.map(np.asarray, jgrads))
    for n, g in grads.items():
        top = float(ref[n].abs().max())
        assert float((g - ref[n]).abs().max()) <= 0.1 * top, n
        assert float((g - want[n]).abs().max()) <= 0.2 * float(
            want[n].abs().max()), n


def test_checkpoints_resume_and_refusals(jax_run, tmp_path, monkeypatch):
    """save_interval 2 over 3 steps writes model_N.pt, ema_{rate}_N.pt and
    opt_N.pt at 2 and at the end (3); a new loop resumes from the latest:
    params, optimizer state, EMAs and step bit-equal, its draws restarted
    from the seed as kdip_tpu's are. An orbax directory is refused, and so
    is a mesh without a process group to run it (the mesh over two ranks:
    test_torch_parallel_ranks.py); DIFFUSION_TRAINING_TEST stops the loop
    after its first save."""
    tmp = str(tmp_path)
    with P.logger.scoped_configure(dir=tmp + "/l", format_strs=[]):
        loop = _port_loop(jax_run["init"], tmp, save_interval=2,
                          measure_gns=False)
        loop.run_loop(max_steps=STEPS)
        names = sorted(os.listdir(os.path.join(tmp, "ck")))
        assert names == sorted(f"{k}_{n}.pt" for n in (2, 3) for k in (
            "model", "ema_0.5", "ema_0.9", "opt"))
        assert P.train_loop.find_resume_checkpoint(
            os.path.join(tmp, "ck")).endswith("model_3.pt")
        back = _port_loop(jax_run["init"], tmp, resume=True)
    assert back.step == STEPS
    for a, b in zip(list(loop.model.parameters())
                    + [p for e in loop.ema_models for p in e.parameters()],
                    list(back.model.parameters())
                    + [p for e in back.ema_models for p in e.parameters()]):
        assert torch.equal(a, b)
    sa, sb = loop.opt.state_dict(), back.opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k, st in sa["state"].items():
        for name, v in st.items():
            assert torch.equal(v, sb["state"][k][name]), name
    assert back.rng.randint(1 << 30) == np.random.RandomState(
        SEED).randint(1 << 30)
    os.makedirs(os.path.join(tmp, "ck", "model_9"))
    with pytest.raises(SystemExit, match="orbax"):
        _port_loop(jax_run["init"], tmp, resume=True)
    with pytest.raises(SystemExit, match="needs an initialized process "
                                         "group"):
        _port_loop(jax_run["init"], tmp, mesh=object())
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    with P.logger.scoped_configure(dir=tmp + "/l2", format_strs=[]):
        short = _port_loop(jax_run["init"], tmp + "/short", save_interval=1)
        short.run_loop(max_steps=10)
    assert short.step == 1
    assert os.path.exists(os.path.join(tmp, "short", "ck", "model_1.pt"))


def test_adamw_and_lr_annealing_match_kdip_tpu(tmp_path):
    """kdip_tpu's jitted update (optax.adamw with its lr_anneal schedule,
    then the EMA chain) and the port's, fed the same gradients for 4
    updates past the end of the annealing (lr 0 from the third on): the
    params and EMAs within 1e-6 relative plus 1e-4 of lr."""
    rng = np.random.default_rng(9)
    params = {"b": rng.standard_normal(4).astype(np.float32),
              "w": rng.standard_normal((3, 4)).astype(np.float32)}
    jloop = JTrainLoop(model_fn=None, params=params,
                       tables=jd.make_diffusion(1000, "linear"), data=None,
                       batch_size=1, lr=1e-2, ema_rate="0.5,0.9",
                       weight_decay=0.3, lr_anneal_steps=2, resume=False,
                       logdir=str(tmp_path / "j"))

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.b = torch.nn.Parameter(torch.from_numpy(params["b"]))
            self.w = torch.nn.Parameter(torch.from_numpy(params["w"]))
    tloop = P.train_loop.TrainLoop(
        model=Tiny(), tables=P.diffusion.make_diffusion(1000, "linear",
                                                        device="cpu"),
        data=None, batch_size=1, lr=1e-2, ema_rate="0.5,0.9",
        weight_decay=0.3, lr_anneal_steps=2, resume=False,
        logdir=str(tmp_path / "t"))
    assert isinstance(tloop.opt, torch.optim.AdamW)
    p, opt, emas = jloop.params, jloop.opt_state, jloop.ema_params
    for _ in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        p, opt, emas = jloop._apply_update(p, opt, g, emas)
        tloop._apply_update([torch.from_numpy(g["b"]),
                             torch.from_numpy(g["w"])])
        tloop.step += 1
        for k in params:
            np.testing.assert_allclose(
                getattr(tloop.model, k).detach().numpy(), np.asarray(p[k]),
                rtol=1e-6, atol=1e-4 * 1e-2)
            for te, je in zip(tloop.ema_models, emas):
                np.testing.assert_allclose(
                    getattr(te, k).detach().numpy(), np.asarray(je[k]),
                    rtol=1e-6, atol=1e-4 * 1e-2)
    assert tloop._lr_schedule(1) == pytest.approx(5e-3)
    assert tloop._lr_schedule(5) == 0.0
