"""The port's scale-out (`kdip_tpu_torch.parallel`) over two gloo ranks on
the CPU, against the same paths in one process and against `kdip_tpu`'s
mesh runs on two of the CPU's virtual devices.

The module fixture writes the inputs (16 px UNets with random weights
moved from flax, `kdip_tpu`'s draws), starts the two ranks once
(tests/test_torch_parallel_worker.py under torchrun's environment: RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT), and while they run computes the
references: the port in this process without a group, and `kdip_tpu`'s
sharded sampler, `grad_norm_stats` under shard_map, TrainLoop with a mesh,
multi-device train step, and `evaluate --dp`. The ranks save what they
got; each test compares one path. Rank r's block of a batch of B is rows
[r B / 2, (r + 1) B / 2).
"""

import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax.sharding import PartitionSpec as JP
from PIL import Image

import kdip_tpu_torch as P
from kdip_tpu import diffusion as jd
from kdip_tpu import gns as jgns
from kdip_tpu import guidance as jg
from kdip_tpu import logger as jlogger
from kdip_tpu import operators as jo
from kdip_tpu import resample as jresample
from kdip_tpu import sampling_api as jsa
from kdip_tpu import train as jtrain
from kdip_tpu import utils as jutils
from kdip_tpu.cli import evaluate as jevaluate
from kdip_tpu.models import adm as jadm
from kdip_tpu.ops.transforms import OrthoTransform as JOrtho
from kdip_tpu.parallel import sharding as jsh
from kdip_tpu.train_loop import TrainLoop as JTrainLoop
from kdip_tpu_torch.cli import evaluate as tevaluate
from kdip_tpu_torch.cli import sample_condition as tcli
from test_torch_port import (REPO, SMALL_UNET, nchw, nhwc,  # noqa: F401
                             one_torch_thread, random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S, N, STEPS, W = 16, 4, 4, 2
# one level without attention, so kdip_tpu's programs compile in half the
# time; 64 channels, so that no GroupNorm group is one channel (the conv
# bias before it would have a zero gradient, and Adam would step on the
# rounding noise of either side)
UNET = dict(SMALL_UNET, model_channels=64, channel_mult=(1,),
            attention_resolutions=())
OP_CFG = dict(name="inpainting", sigma_s=0.05,
              mask_opt=dict(mask_type="random", mask_prob_range=(0.5, 0.5),
                            image_size=S))
SCFG = dict(steps=STEPS, sigma_max=2.0, per_sample_map=False)
CASES = {"pgdm": dict(v2=False, gcfg=dict(guidance="pgdm",
                                          x0_cov_type="pgdm")),
         "dwt_var": dict(v2=True, gcfg=dict(guidance="I",
                                            ortho_tf_type="dwt",
                                            mle_sigma_thres=1.0))}
# DWT-Var Type-I with the preconditioned CG, whose preconditioner is the
# closed-form inverse at the batch's mean variance (guidance._batch_mean),
# held against one process only
PRECOND = dict(CASES["dwt_var"], gcfg=dict(CASES["dwt_var"]["gcfg"],
                                           cg_precondition=True))
LOOP = dict(unet=UNET, B=4, MB=2, steps=2,
            lr=1e-4, ema="0.5,0.9", seed=3, dropout=0.1)
# the other reductions over the batch, held against one process only:
# dps's norm of the residual and stsl's norm, probe sums and element count
# (their gradients through the group's sum), their draws and stsl's probes
# from a generator seeded with GEN_SEED
PORT_CASES = {"dps": dict(guidance="dps", x0_cov_type="dps", zeta=1.0),
              "stsl": dict(guidance="stsl", x0_cov_type="pgdm", zeta=1.0,
                           eta=50.0, num_hutchinson_samples=2)}
GEN_SEED = 9
PIXELS = 4
CLI_MODEL = {
    "type": "openai_ffhq", "input_channels": 3, "input_size": [S, S],
    "sigma_min": 1e-2, "sigma_max": 80, "ortho_tf_type": "dwt",
    "openai": {"num_channels": 32, "num_res_blocks": 1,
               "attention_resolutions": "8", "image_size": S,
               "num_head_channels": 16, "channel_mult": "1,2",
               "dropout": 0.0}}


# the ranks take ~15 s alone; a rank that fails leaves the other waiting
# in a collective, which _wait ends at once
RANKS_TIMEOUT = 300


def _wait(procs, timeout: float) -> None:
    """Waits for the ranks; once one exits with an error, or the timeout
    passes, kills the rest."""
    deadline = time.time() + timeout
    while any(p.poll() is None for p in procs):
        if time.time() > deadline or any(p.poll() not in (None, 0)
                                         for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.2)
    for p in procs:
        p.wait()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_draws(key):
    """The standard-normal draws kdip_tpu's Heun sampler makes from key
    (tests/test_torch_sampling.py)."""
    k_init, k = jax.random.split(key)
    init = jax.random.normal(k_init, (N, S, S, 3))
    churn = []
    for _ in range(STEPS):
        k, k_churn, _, _ = jax.random.split(k, 4)
        churn.append(nchw(jax.random.normal(k_churn, (N, S, S, 3))))
    return nchw(init), churn


def _jax_loop_noise(n):
    """kdip_tpu's TrainLoop noise, its key chain replayed: one split a
    microbatch (tests/test_torch_train_loop.py)."""
    key, out = jax.random.key(LOOP["seed"]), []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(
            k, (LOOP["MB"], S, S, 3), jnp.float32)))
    return out


def _pngs(folder, n, seed):
    os.makedirs(folder)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray((rng.rand(S, S, 3) * 255).astype(np.uint8)).save(
            os.path.join(folder, f"{i}.png"))


def _inputs(d):
    """Everything the ranks and the references share, and kdip_tpu's
    side of it."""
    inp, jx = {"unet": UNET, "size": S, "op_cfg": OP_CFG,
               "scfg": SCFG, "sampler": {}, "gen_seed": GEN_SEED}, {}
    jop = jo.get_operator(seed=1, **OP_CFG)
    rng = np.random.RandomState(4)
    x0 = rng.uniform(-1, 1, (N, S, S, 3)).astype(np.float32)
    y = (x0 + 0.05 * rng.standard_normal(x0.shape).astype(np.float32)
         ) * np.asarray(jop.mask)
    init, churn = _jax_draws(jax.random.key(11))
    for i, (case, c) in enumerate(CASES.items()):
        jm = jadm.ADMUNet(**UNET)
        jm = jadm.ADMUNetV2(unet=jm) if c["v2"] else jm
        params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                    jnp.zeros((1,)), seed=20 + i)
        jx[case] = (jm, params)
        inp["sampler"][case] = dict(
            c, state_dict=P.weights.from_jax_params(params), y=nchw(y),
            init=init, churn=churn)
    inp["sampler"]["precond"] = dict(
        PRECOND, state_dict=inp["sampler"]["dwt_var"]["state_dict"],
        y=nchw(y), init=init, churn=churn)
    for case, gcfg in PORT_CASES.items():
        inp["sampler"][case] = dict(
            v2=False, gcfg=gcfg, y=nchw(y),
            state_dict=inp["sampler"]["pgdm"]["state_dict"])
    inp["v1_path"] = os.path.join(d, "v1.pt")
    torch.save(inp["sampler"]["pgdm"]["state_dict"], inp["v1_path"])
    jx["y"] = y
    # grad_norm_stats: each rank's local gradients; the resampler: each
    # round's global (t, loss) pairs, 3 on rank 0 and 2 on rank 1
    g = np.random.default_rng(5)
    inp["gns"] = [[g.standard_normal(s).astype(np.float32)
                   for s in ((3, 4), (5,), (2, 2, 2))] for _ in range(W)]
    ts = (np.arange(60) * 7) % 20
    losses = g.uniform(0.1, 2.0, 60)
    rounds = [(ts[i:i + 5], losses[i:i + 5]) for i in range(0, 60, 5)]
    inp["resample"] = [[(t[:3], v[:3]) for t, v in rounds],
                       [(t[3:], v[3:]) for t, v in rounds]]
    jx["resample"] = rounds
    # the TrainLoop: float32 ADM at 64 channels, 2 steps of 4 in 2 x 2
    jl = jadm.ADMUNet(**LOOP["unet"])
    lp = random_flax_params(jl.init, jnp.zeros((1, S, S, 3)),
                            jnp.zeros((1,)), seed=4)
    br = np.random.RandomState(0)
    batches = [br.rand(LOOP["B"], S, S, 3).astype(np.float32) * 2 - 1
               for _ in range(LOOP["steps"])]
    noise = _jax_loop_noise(LOOP["steps"] * LOOP["B"] // LOOP["MB"])
    inp["loop"] = dict(LOOP, state_dict=P.weights.from_jax_params(lp),
                       batches=[nchw(b) for b in batches],
                       noise=[nchw(n) for n in noise],
                       logdir=os.path.join(d, "loop"))
    jx["loop"] = (jl, lp, batches)
    # one train_openai step: the 16 px V2 model, kdip_tpu's draws
    jv = jadm.ADMUNetV2(unet=jadm.ADMUNet(**UNET))
    vp = random_flax_params(jv.init, jnp.zeros((1, S, S, 3)),
                            jnp.zeros((1,)), seed=23)
    density = jutils.make_sample_density(
        {"sigma_sample_density": {"type": "cosine"}}, 0.5, 1e-2, 80.0)
    key = jax.random.key(5)
    k_sigma, k_noise = jax.random.split(key)
    sx0 = np.random.RandomState(1).uniform(-1, 1, (N, S, S, 3)).astype(
        np.float32)
    sigma = density(k_sigma, (N,))
    snoise = jax.random.normal(k_noise, (N, S, S, 3), jnp.float32)
    inp["step"] = dict(unet=UNET, lr=1e-4, decay=0.5,
                       state_dict=P.weights.from_jax_params(vp),
                       x0=nchw(sx0), sigma=torch.tensor(np.asarray(sigma)),
                       noise=nchw(snoise))
    jx["step"] = (jv, vp, density, key, sx0)
    # FSDP2 against a replicated copy
    fr = np.random.RandomState(2)
    inp["fsdp"] = dict(
        unet=UNET, state_dict=inp["sampler"]["pgdm"]["state_dict"],
        x=torch.from_numpy(fr.uniform(-1, 1, (N, 3, S, S)).astype(
            np.float32)), t=torch.tensor([3.0, 100.0, 500.0, 900.0]))
    # evaluate: two folders of 5 PNGs in batches of 4 (a tail of 1)
    for name, seed in (("real", 0), ("fake", 1)):
        _pngs(os.path.join(d, name), 5, seed)
    inp["eval"] = dict(pixels_size=PIXELS, argv=[
        os.path.join(d, "real"), os.path.join(d, "fake"), "--backbone",
        "pixels", "--size", str(S), "--batch-size", "4", "--device", "cpu"])
    # the guided CLI, DWT-Var (--v2) on 2 images in one batch of 2
    _pngs(os.path.join(d, "val"), 2, 3)
    cfg = os.path.join(d, "config.json")
    with open(cfg, "w") as f:
        json.dump({"model": CLI_MODEL, "dataset": {
            "type": "imagefolder", "location": os.path.join(d, "val")}}, f)
    op = os.path.join(d, "inpainting.yaml")
    with open(op, "w") as f:
        yaml.safe_dump(OP_CFG, f, default_flow_style=None)
    unet = P.config.make_openai_model(CLI_MODEL, device="cpu")[0]
    pt = os.path.join(d, "v2.pt")
    torch.save(P.weights.randomize_(P.adm.ADMUNetV2(unet), 7).state_dict(),
               pt)

    def argv(logdir, batch):
        return ["--checkpoint", pt, "--config", cfg, "--operator-config", op,
                "--logdir", logdir, "--steps", "3", "--dtype", "float32",
                "--v2", "--batch-size", str(batch), "--save-img",
                "--device", "cpu"]
    inp["cli"] = dict(argv=argv(os.path.join(d, "cli_dp"), 2),
                      argv_odd=argv(os.path.join(d, "cli_odd"), 3),
                      logdir=os.path.join(d, "cli_dp"))
    jx["cli_one"] = argv(os.path.join(d, "cli_one"), 2)
    return inp, jx


def _kdip_sampler(jx, case, mesh):
    """kdip_tpu's make_sharded_sampler over the mesh: (samples, the worst
    CG residual)."""
    c = CASES[case]
    jm, params = jx[case]
    sampler = jsa.build_posterior_sampler(
        lambda p, x, t: jm.apply({"params": p}, x,
                                 jnp.asarray(t, jnp.float32)),
        jd.make_diffusion(1000, "linear"), jo.get_operator(seed=1, **OP_CFG),
        jg.GuidanceConfig(**c["gcfg"]), jsa.SamplerConfig(**SCFG),
        v2=c["v2"], image_size=S)
    out, info = jsh.make_sharded_sampler(
        lambda p, m, k: sampler(p, m, k, n=N, return_info=True),
        mesh)(params, jo.Measurement(y=jnp.asarray(jx["y"])),
              jax.random.key(11))
    return np.asarray(out), float(info["cg_max_residual"])


def _kdip_loop(inp, jx, mesh):
    """kdip_tpu's TrainLoop(mesh=...): params, EMAs, history counts."""
    jl, lp, batches = jx["loop"]
    d = inp["loop"]["logdir"] + "_jax"
    with jlogger.scoped_configure(dir=d + "/log", format_strs=[]):
        loop = JTrainLoop(
            model_fn=lambda p, x, t: jl.apply({"params": p}, x,
                                              t.astype(jnp.float32)),
            params=lp, tables=jd.make_diffusion(1000, "linear"),
            data=iter(batches), batch_size=LOOP["B"], microbatch=LOOP["MB"],
            lr=LOOP["lr"], ema_rate=LOOP["ema"], log_interval=100,
            save_interval=100, logdir=d,
            schedule_sampler=jresample.LossSecondMomentResampler(1000),
            loss_type="rescaled_mse", resume=False, seed=LOOP["seed"],
            measure_gns=True, mesh=mesh)
        loop.run_loop(max_steps=LOOP["steps"])
    return (jax.tree.map(np.asarray, loop.params),
            [jax.tree.map(np.asarray, e) for e in loop.ema_params],
            loop.schedule_sampler._loss_counts.copy())


def _kdip_step(jx, mesh):
    """kdip_tpu's train_openai step, its state replicated over the mesh
    and the batch sharded: (loss, params, EMA)."""
    jv, vp, density, key, sx0 = jx["step"]
    jlog = jd.make_diffusion(1000, "linear").log_sigmas
    opt = optax.adam(1e-4)

    def loss_fn(p, x, noise, sigma):
        return jtrain.openai_v2_loss(
            lambda pp, xx, tt: jv.apply({"params": pp}, xx, tt,
                                        deterministic=True),
            p, x, noise, sigma, jlog, JOrtho("dwt"))
    state = jsh.replicate(jtrain.create_train_state(vp, opt), mesh)
    state, m = jax.jit(jtrain.make_train_step(loss_fn, opt, density))(
        state, jsh.shard_batch(jnp.asarray(sx0), mesh), key, 0.5)
    return (float(m["loss"]), jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.ema_params))


def _kdip_references(inp, jx):
    """kdip_tpu's runs on a mesh of two of the CPU's virtual devices; the
    four compiled ones on threads, so their compiles overlap."""
    mesh = jsh.make_mesh(W)
    with ThreadPoolExecutor(4) as pool:
        jobs = {case: pool.submit(_kdip_sampler, jx, case, mesh)
                for case in CASES}
        jobs["loop"] = pool.submit(_kdip_loop, inp, jx, mesh)
        jobs["step"] = pool.submit(_kdip_step, jx, mesh)
        ref = {k: job.result() for k, job in jobs.items()}
    stats = jax.shard_map(
        lambda gs: jgns.grad_norm_stats(gs, "dp"), mesh=mesh,
        in_specs=(JP("dp"),), out_specs=(JP(), JP()))(
        [jnp.stack(leaves) for leaves in zip(*inp["gns"])])
    ref["gns"] = [float(v) for v in stats]
    rs = jresample.LossSecondMomentResampler(20, history_per_term=2)
    for ts, losses in jx["resample"]:
        rs.update_with_local_losses(ts, losses)
    ref["resample"] = (rs.weights(), rs._loss_history.copy())
    return ref


def _port_references(inp, jx, d, monkeypatch):
    """The same paths in this process, without a process group."""
    import test_torch_parallel_worker as worker
    ref = {}
    for case in list(CASES) + ["precond"]:
        c = inp["sampler"][case]
        ref[case] = worker.sampler_case(inp, case)(
            P.operators.Measurement(y=c["y"]), n=N, init_noise=c["init"],
            noise_fn=c["churn"].__getitem__, return_info=True)
    for case in PORT_CASES:
        ref[case] = worker.sampler_case(inp, case)(
            P.operators.Measurement(y=inp["sampler"][case]["y"]), n=N,
            generator=torch.Generator().manual_seed(GEN_SEED),
            return_info=True)
    ref["generator"] = worker.sampler_case(inp, "pgdm")(
        P.operators.Measurement(y=inp["sampler"]["pgdm"]["y"]), n=N,
        generator=torch.Generator().manual_seed(GEN_SEED), return_info=True)
    for key, dropout in (("loop", 0.0), ("loop_dropout", LOOP["dropout"])):
        t = dict(inp["loop"], logdir=os.path.join(d, key + "_one"))
        with P.logger.scoped_configure(dir=t["logdir"], format_strs=[]):
            ref[key] = worker.train_loop(dict(inp, loop=t), None, dropout)
    t = inp["step"]
    model = P.adm.ADMUNetV2(P.adm.ADMUNet(**t["unet"], device="cpu"))
    model.load_state_dict(t["state_dict"])
    tlog = P.diffusion.make_diffusion(1000, "linear", device="cpu").log_sigmas
    state = P.train.TrainState(model, t["lr"])
    loss = P.train.make_train_step(
        lambda x, noise, sigma: P.train.openai_v2_loss(
            model, x, noise, sigma, tlog,
            P.transforms.OrthoTransform("dwt")), None)(
        state, t["x0"], t["decay"], sigma=t["sigma"], noise=t["noise"])
    ref["step"] = (float(loss), model.state_dict())
    monkeypatch.setattr(tevaluate, "PIXELS_SIZE", PIXELS)
    ref["evaluate"] = tevaluate.main(inp["eval"]["argv"])
    ref["cli"] = tcli.main(jx["cli_one"])
    ref["cli_files"] = sorted(os.listdir(jx["cli_one"][
        jx["cli_one"].index("--logdir") + 1]))
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    inp, jx = _inputs(d)
    torch.save(inp, os.path.join(d, "inputs.pt"))
    port = _free_port()
    procs, logs = [], [os.path.join(d, f"rank{r}.log") for r in range(W)]
    for r in range(W):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(W), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, os.path.join(
                       REPO, "tests")]))
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(
                    REPO, "tests", "test_torch_parallel_worker.py"), d],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    mp = pytest.MonkeyPatch()
    try:
        kdip = _kdip_references(inp, jx)
        # kdip_tpu's --dp over the 8 virtual devices, its pixels resized to
        # PIXELS x PIXELS like the port's (jax.image.resize, patched here)
        resize = jax.image.resize
        mp.setattr(jax.image, "resize", lambda x, shape, method: resize(
            x, (shape[0], PIXELS, PIXELS, shape[3]), method))
        kdip["evaluate"] = jevaluate.main(
            inp["eval"]["argv"][:-2] + ["--dp"])
        mp.undo()
        one = _port_references(inp, jx, d, mp)
    finally:
        mp.undo()
        _wait(procs, RANKS_TIMEOUT)
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            assert p.returncode == 0, f"rank {r}:\n{f.read()[-4000:]}"
    got = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
           for r in range(W)]
    return dict(inp=inp, got=got, one=one, kdip=kdip)


def _adam_close(got, want, what):
    """Parameters after Adam steps (float32 both sides) within 1e-6
    relative plus 1e-4 of lr, save for at most 0.1% of the elements, and
    every element within 1e-6 relative plus 1 lr: Adam divides each
    gradient by its own RMS, so where an element's gradient is near 0 a
    ~1e-6 relative difference of the gradients (sums in another order)
    becomes a different step (tests/test_torch_train_loop.py's bound)."""
    assert sorted(got) == sorted(want), what
    lr = LOOP["lr"]
    beyond = total = 0
    for k, w in want.items():
        d = (got[k].detach() - w).abs() - 1e-6 * w.abs()
        assert float(d.max()) <= lr, f"{what}: {k}"
        beyond += int((d > 1e-4 * lr).sum())
        total += w.numel()
    assert beyond <= 1e-3 * total, (what, beyond, total)


def _from_jax(tree):
    return P.weights.from_jax_params(tree)


def _whole(ranks, key):
    """The ranks' blocks in rank order, and their infos."""
    outs = [g[key] for g in ranks["got"]]
    return torch.cat([o[0] for o in outs]), [o[1] for o in outs]


def test_rank0_byte_broadcast_and_sync_params(ranks):
    """Rank 1 is given a path that does not exist and gets rank 0's
    tensors, bit for bit, through the byte broadcast; sync_params leaves
    rank 0's parameters on both ranks."""
    want = ranks["inp"]["sampler"]["pgdm"]["state_dict"]
    for g in ranks["got"]:
        assert g["world"] == W
        assert sorted(g["broadcast"]) == sorted(want)
        for k, v in want.items():
            assert torch.equal(g["broadcast"][k], v), k
        assert torch.equal(g["sync"]["weight"], torch.ones(2, 3))
        assert torch.equal(g["sync"]["bias"], torch.zeros(2))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_sampler_matches_one_process_and_kdip_tpu(ranks, case):
    """The two ranks' blocks, in rank order, against the one-process
    batched sampler on the same injected draws, and against kdip_tpu's
    make_sharded_sampler on a 2-device mesh. Within 2e-4 of one process:
    each rank's UNet runs a batch of 2 where one process runs 4, and the
    CPU's convolutions round otherwise at another batch size (pgdm,
    whose closed form reduces nothing over the batch, is not bit-equal
    for that alone), carried through 7 NFEs (measured 6.7e-5 for DWT-Var).
    DWT-Var Type-I below its threshold runs one joint CG over the 4
    samples, its inner products summed across the ranks: the same
    iteration count on both ranks as in one process, the residual within
    1e-3 relative. Against kdip_tpu within 2e-3 and its residual within
    0.1% (tests/test_torch_sampling.py's batched bounds)."""
    out, infos = _whole(ranks, case)
    one, one_info = ranks["one"][case]
    assert infos[0] == infos[1]
    assert infos[0]["cg_total_iters"] == one_info["cg_total_iters"]
    assert (infos[0]["cg_total_iters"] > 0) == (case == "dwt_var")
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=2e-4)
    np.testing.assert_allclose(infos[0]["cg_max_residual"],
                               one_info["cg_max_residual"], rtol=1e-3)
    want, resid = ranks["kdip"][case]
    np.testing.assert_allclose(nhwc(out), want, atol=2e-3)
    np.testing.assert_allclose(infos[0]["cg_max_residual"], resid,
                               rtol=1e-3)


def test_sharded_preconditioned_cg_matches_one_process(ranks):
    """DWT-Var Type-I with cg_precondition, its preconditioner the inverse
    at the whole batch's mean variance (summed across the ranks): both
    ranks take the one process's CG iterations and exit at its residual
    within 1e-3 relative, the blocks within the 2e-4 above (a mean over
    each rank's block alone preconditions each rank otherwise)."""
    out, infos = _whole(ranks, "precond")
    one, one_info = ranks["one"]["precond"]
    assert infos[0] == infos[1]
    assert infos[0]["cg_total_iters"] == one_info["cg_total_iters"] > 0
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=2e-4)
    np.testing.assert_allclose(infos[0]["cg_max_residual"],
                               one_info["cg_max_residual"], rtol=1e-3)


def test_sharded_sampler_draws_the_global_batch(ranks):
    """Drawing from a torch generator (pgdm), every rank makes the global
    batch's init and churn draws and keeps its block: rank r's samples are
    rows r of the one-process run, within the 2e-4 above (a draw of the
    wrong rows would be off by O(1))."""
    out, _ = _whole(ranks, "generator")
    np.testing.assert_allclose(out.numpy(),
                               ranks["one"]["generator"][0].numpy(),
                               atol=2e-4)


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_sharded_dps_and_stsl_match_one_process(ranks, case):
    """dps (the norm of y - A x0_mean over the whole batch) and stsl (that
    norm, the probe terms' sum and the element count over the whole batch,
    the probes drawn for the global batch and sliced) over 2 ranks, their
    gradients through the group's sum: the blocks within the 2e-4 above
    of the one-process batched run (a norm over one rank's block alone
    would scale each rank's step by up to sqrt(2))."""
    out, infos = _whole(ranks, case)
    assert infos[0] == infos[1] == {"cg_max_residual": 0.0,
                                    "cg_total_iters": 0}
    np.testing.assert_allclose(out.numpy(), ranks["one"][case][0].numpy(),
                               atol=2e-4)


def test_grad_norm_stats_match_kdip_tpu(ranks):
    """Each rank's (sq_small, sq_big) from one all_reduce, against
    kdip_tpu's grad_norm_stats under shard_map over the same local
    gradients, within 1e-6 relative (float32 sums)."""
    for g in ranks["got"]:
        np.testing.assert_allclose(g["gns"], ranks["kdip"]["gns"],
                                   rtol=1e-6)


def test_grad_norm_stats_without_a_group_is_local(ranks):
    """grad_norm_stats without a group, in a process that has joined one,
    reduces nothing: both statistics are the rank's own squared gradient
    norm (float32 sums, 1e-6 relative)."""
    for r, g in enumerate(ranks["got"]):
        sq = sum(float(np.sum(np.square(x, dtype=np.float64)))
                 for x in ranks["inp"]["gns"][r])
        np.testing.assert_allclose(g["gns_local"], [sq, sq], rtol=1e-6)


def test_resampler_gathers_every_ranks_losses(ranks):
    """Ranks holding 3 and 2 of each round's (t, loss) pairs, gathered
    (padded to 3) in rank order: the history and the weights equal
    kdip_tpu's sampler fed each round's 5 global pairs, on both ranks."""
    weights, history = ranks["kdip"]["resample"]
    for g in ranks["got"]:
        np.testing.assert_array_equal(g["resample"][1], history)
        np.testing.assert_array_equal(g["resample"][0], weights)


def test_train_loop_matches_one_process_and_kdip_tpu(ranks):
    """Two TrainLoop steps (batch 4 in microbatches of 2, the loss-aware
    sampler, GNS, two EMAs) over the 2-rank mesh: params and EMAs against
    the one-process loop and against kdip_tpu's TrainLoop(mesh=2 devices),
    as _adam_close holds them (measured: 0 elements beyond 1e-4 of lr
    against one process); the sampler's history counts equal. With
    dropout 0.1 live, the masks drawn for the global microbatch and
    sliced: params and EMAs again as one process gives them."""
    jparams, jemas, jcounts = ranks["kdip"]["loop"]
    for g in ranks["got"]:
        for key in ("loop", "loop_dropout"):
            one = ranks["one"][key]
            _adam_close(g[key]["params"], one["params"], key)
            for ema, want in zip(g[key]["emas"], one["emas"]):
                _adam_close(ema, want, key + " ema")
            np.testing.assert_array_equal(g[key]["counts"], one["counts"])
        _adam_close(g["loop"]["params"], _from_jax(jparams), "kdip params")
        for ema, want in zip(g["loop"]["emas"], jemas):
            _adam_close(ema, _from_jax(want), "kdip ema")
        np.testing.assert_array_equal(g["loop"]["counts"], jcounts)


def test_train_step_matches_one_process_and_kdip_tpu(ranks):
    """One data-parallel train_openai step (batch 4, the gradients and the
    loss averaged over the ranks before Adam): the loss within 1e-6
    relative of the one-process step and 1e-5 of kdip_tpu's step on the
    2-device mesh; params and EMA as _adam_close holds them, against
    both."""
    loss1, params1 = ranks["one"]["step"]
    jloss, jparams, jema = ranks["kdip"]["step"]
    for g in ranks["got"]:
        s = g["step"]
        assert s["loss"] == pytest.approx(loss1, rel=1e-6)
        assert s["loss"] == pytest.approx(jloss, rel=1e-5)
        _adam_close(s["params"], params1, "params")
        _adam_close(s["params"], _from_jax(jparams), "kdip params")
        _adam_close(s["ema"], _from_jax(jema), "kdip ema")


def test_fsdp_matches_replicated(ranks):
    """FSDP2 (shard_params_fsdp over a ("fsdp",) mesh) against a
    replicated copy on the global batch: every parameter sharded on the
    dimension fsdp_spec picks (dim 0 where none divides); the loss within
    1e-6 relative and every gradient within 1e-5 of its tensor's largest
    element (float32; the reduce-scatter sums in another order)."""
    for g in ranks["got"]:
        f = g["fsdp"]
        for n, shape in f["shapes"].items():
            spec = P.sharding.fsdp_spec(torch.empty(shape), W)
            assert f["placements"][n] == (spec.index("fsdp") if spec
                                          else 0), n
        assert f["loss"] == pytest.approx(f["ref_loss"], rel=1e-6)
        for n, want in f["ref_grads"].items():
            err = float((f["grads"][n] - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()) + 1e-12, n


def test_evaluate_dp_matches_one_process_and_kdip_tpu(ranks):
    """evaluate --dp (5 images a folder in batches of 4; the tail of 1
    padded to 2, split, gathered): every rank reports what one process
    reports, FID and KID bit for bit (the same features); against
    kdip_tpu's --dp over 8 virtual devices (its tail padded to 8), FID
    within 1e-3 relative and KID within 1e-6 (pixels resized to 4 x 4 in
    both, so the 48-dim FID is cheap)."""
    one, kdip = ranks["one"]["evaluate"], ranks["kdip"]["evaluate"]
    for g in ranks["got"]:
        assert g["evaluate"] == one
        assert g["evaluate"]["n_real"] == g["evaluate"]["n_fake"] == 5
    assert one["fid"] == pytest.approx(kdip["fid"], rel=1e-3)
    assert one["kid"] == pytest.approx(kdip["kid"], abs=1e-6)


def test_evaluate_dp_decodes_each_image_once(ranks):
    """Under evaluate --dp a rank decodes its block of each batch alone:
    over the two ranks every image of both folders is decoded once (rank 0
    images 0, 1 and the tail's 4, rank 1 images 2 and 3)."""
    got = [sorted(g["decoded"]) for g in ranks["got"]]
    for name in ("real", "fake"):
        assert [[i for n, i in d if n == name] for d in got] == [
            [0, 1, 4], [2, 3]]


def test_cli_dp_matches_the_batched_run(ranks):
    """sample_condition --dp --v2 (DWT-Var) with a batch of 2 over 2 ranks
    against the CLI's one-process batched run: the same files (rank 0
    alone writes them), the averages within 1e-3 dB PSNR and 1e-5 SSIM on
    both ranks (rank 0 broadcasts them), the CG's worst residual within
    1e-3 relative. A --batch-size the world size does not divide is
    refused."""
    one = ranks["one"]["cli"]
    for g in ranks["got"]:
        assert g["cli_files"] == ranks["one"]["cli_files"]
        assert g["cli"]["psnr"] == pytest.approx(one["psnr"], abs=1e-3)
        assert g["cli"]["ssim"] == pytest.approx(one["ssim"], abs=1e-5)
        assert g["cli"]["cg_max_residual"] == pytest.approx(
            one["cg_max_residual"], rel=1e-3)
        assert "divisible by the world size (2)" in g["odd_batch"]
