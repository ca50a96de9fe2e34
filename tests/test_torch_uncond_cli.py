"""The port's unconditional-sampling CLI (`kdip_tpu_torch.cli.sample_uncond`)
against `kdip_tpu.cli.sample_uncond.main`, on a 16 px ADM UNet, float32,
on the CPU (`--device cpu`), and the guided path on a respaced config.

jax's and torch's draws differ, so the port is handed `kdip_tpu`'s: the
initial x from the first half of split(key), the discrete chains' per-step
normals from the second half's splits (ddpm_sampling.py:107-117), and
dpmpp_sde's Brownian noise as `kdip_tpu`'s tree answers each of the port's
(sigma, sigma') queries. The other Karras samplers draw nothing that the
CLI's settings use (no churn).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import config as jconfig
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu.cli import sample_uncond as jcli
from kdip_tpu.models import adm as jadm
from kdip_tpu_torch import data as tdata
from kdip_tpu_torch.cli import sample_uncond as tcli
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params
from test_torch_samplers_rest import tree_replay

S, N, STEPS = 16, 2, 3
MODEL_CFG = {
    "type": "openai_ffhq", "input_channels": 3, "input_size": [S, S],
    "sigma_min": 1e-2, "sigma_max": 80,
    "openai": {"num_channels": 32, "num_res_blocks": 1,
               "attention_resolutions": "8", "image_size": S,
               "num_head_channels": 16, "channel_mult": "1,2",
               "dropout": 0.0}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: under the suite's parallel workers, torch's
    per-op thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The config JSON and a guided-diffusion .pt of seeded random weights
    (std 0.05, so that eps is far from 0)."""
    root = tmp_path_factory.mktemp("uncond_cli")
    cfg = str(root / "config.json")
    with open(cfg, "w") as f:
        json.dump({"model": MODEL_CFG}, f)
    unet = P.config.make_openai_model(MODEL_CFG, device="cpu")[0]
    pt = str(root / "model.pt")
    torch.save(P.weights.randomize_(unet, 0, std=0.05).state_dict(), pt)
    return {"root": root, "config": cfg, "pt": pt}


def _argv(env, sampler, logdir, *extra):
    argv = ["--checkpoint", env["pt"], "--config", env["config"], "-n",
            str(N), "--sampler", sampler, "--steps", str(STEPS), "--dtype",
            "float32", "--logdir", str(logdir), "--seed", "3"]
    if sampler in ("ancestral", "ddim"):
        argv += ["--respacing", "5"]
    return argv + list(extra)


def _jax_draws(sampler, seed=3):
    """(init_noise, noise_fn, noise_sampler) replaying kdip_tpu's CLI draws
    (sample_uncond.py:88-115)."""
    shape = (N, S, S, 3)
    key = jax.random.key(seed)
    if sampler in ("ancestral", "ddim"):
        k_init, k = jax.random.split(key)
        steps = []
        for _ in range(5):
            k, k_step = jax.random.split(k)
            steps.append(nchw(jax.random.normal(k_step, shape)))
        return nchw(jax.random.normal(k_init, shape)), steps.__getitem__, None
    k1, k2 = jax.random.split(key)
    init = nchw(jax.random.normal(k1, shape))
    if sampler != "dpmpp_sde":
        return init, None, None
    sig = np.asarray(P.schedules.get_sigmas_karras(STEPS, 1e-2, 80.0))
    return init, None, tree_replay(k2, sig, shape)


# Relative to the largest |x|. Measured: 1.0e-6 to 4.9e-6 for the
# deterministic Karras samplers (float32 host scalars against float32
# device scalars, the UNets' float32 sums in another order); 2.5e-5 for
# dpmpp_sde, whose noise kdip_tpu's tree gives at the port's sigmas, an ulp
# from kdip_tpu's own: W is rough, so an ulp of t moves it by ~sqrt(ulp)
# (tests/test_torch_samplers_rest.py);
# 4.3e-5 to 1.7e-4 for the discrete chains, whose pred_xstart multiplies
# eps's float32 noise by sqrt(1/abar - 1), up to 157 at t = 999.
KARRAS_RTOL, SDE_RTOL, CHAIN_RTOL = 1e-5, 1e-4, 5e-4


@pytest.mark.parametrize("sampler,extra,rtol", [
    ("heun", (), KARRAS_RTOL), ("euler", (), KARRAS_RTOL),
    ("dpmpp_2m", (), KARRAS_RTOL), ("dpmpp_sde", (), SDE_RTOL),
    ("lms", (), KARRAS_RTOL), ("dpm_2", (), KARRAS_RTOL),
    ("ancestral", (), CHAIN_RTOL), ("ddim", (), CHAIN_RTOL),
    ("ddim", ("--eta", "0.5"), CHAIN_RTOL)])
def test_cli_matches_kdip_tpu(env, tmp_path, sampler, extra, rtol):
    """Every --sampler choice, 3 steps (respacing 5 for the discrete
    chains), -n 2, float32: the port's samples within `rtol` of the largest
    |x| of kdip_tpu's, given kdip_tpu's draws; the PNGs are the port's
    samples as data.read_png reads them back, under kdip_tpu's names."""
    want = jcli.main(_argv(env, sampler, tmp_path / "jax", *extra))
    init, noise_fn, noise_sampler = _jax_draws(sampler)
    got = tcli.main(_argv(env, sampler, tmp_path / "torch", *extra,
                          "--device", "cpu"), init_noise=init,
                    noise_fn=noise_fn, noise_sampler=noise_sampler)
    scale = np.abs(want).max()
    err = np.abs(nhwc(got) - want).max() / scale
    assert got.shape == (N, 3, S, S) and err <= rtol, err
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "sample_0.png", "sample_1.png"]
    for i in range(N):
        png = tdata.read_png(str(tmp_path / "torch" / f"sample_{i}.png"))
        np.testing.assert_array_equal(png, tdata.to_uint8_image(got[i]))


@pytest.mark.parametrize("sampler", ["dpmpp_sde", "ancestral"])
def test_cli_draws_from_its_seed(env, tmp_path, sampler):
    """Without injected draws the CLI is a function of --seed: two runs are
    bit-equal (dpmpp_sde's Brownian tree seeded from the sampler's
    generator, the chain's normals from it), another seed differs."""
    runs = []
    for i, seed in enumerate((4, 4, 5)):
        argv = _argv(env, sampler, tmp_path / str(i), "--device", "cpu")
        argv[argv.index("--seed") + 1] = str(seed)
        runs.append(tcli.main(argv))
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("case", ["orbax", "no_card"])
def test_refusals(env, tmp_path, case, monkeypatch):
    """An orbax directory checkpoint is refused, as sample_condition
    refuses it; --device cuda without a card exits, never falling back to
    the CPU. Neither writes a sample."""
    logdir = tmp_path / "x"
    argv = _argv(env, "heun", logdir)
    if case == "orbax":
        argv[argv.index("--checkpoint") + 1] = str(env["root"])
        argv += ["--device", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match={"orbax": "orbax",
                                          "no_card": "no CUDA card"}[case]):
        tcli.main(argv)
    assert not logdir.exists()


def test_respaced_guided_denoise_matches(env):
    """make_openai_model with "timestep_respacing": "ddim50" gives both
    packages the same 50-entry tables (timestep_map included), and one
    Type-I Convert guided denoise on inpainting over them matches
    kdip_tpu's within 1e-3, below and above the 0.2 threshold: both feed
    the model the respaced index, as kdip_tpu's guidance ignores
    timestep_map."""
    s = SMALL_UNET["image_size"]
    mc = {"openai": {"timestep_respacing": "ddim50"}}
    jtab = jconfig.make_openai_model(mc)[1]
    ttab = P.config.make_openai_model(mc, device="cpu")[1]
    assert ttab.num_timesteps == 50
    for name in jtab._fields:
        np.testing.assert_array_equal(getattr(ttab, name).numpy(),
                                      np.asarray(getattr(jtab, name)))
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, s, s, 3)),
                                jnp.zeros((1,)), seed=2)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    op_cfg = dict(name="inpainting", sigma_s=0.05, mask_opt=dict(
        mask_type="random", mask_prob_range=(0.5, 0.5), image_size=s))
    jop = jo.get_operator(seed=0, **op_cfg)
    top = P.operators.get_operator(seed=0, device="cpu", **op_cfg)
    rng = np.random.RandomState(1)
    y = rng.uniform(-1, 1, (1, s, s, 3)).astype(np.float32) * np.asarray(
        jop.mask)
    cfg = dict(guidance="I", x0_cov_type="convert")
    jcfg = jg.GuidanceConfig(**cfg)
    ju, jv = jg.make_openai_uncond(
        lambda p, x, t: jm.apply({"params": p}, x, jnp.asarray(t,
                                                               jnp.float32)),
        jtab, jcfg)
    jden = jax.jit(jg.make_condition_denoiser(
        ju, jv, jop, jo.Measurement(y=jnp.asarray(y)), jcfg, params=params))
    tcfg = P.guidance.GuidanceConfig(**cfg)
    tu, tv = P.guidance.make_openai_uncond(tm, ttab, tcfg)
    tden = P.guidance.make_condition_denoiser(
        tu, tv, top, P.operators.Measurement(y=nchw(y)), tcfg)
    xs = rng.standard_normal((1, s, s, 3)).astype(np.float32)
    for sigma in (0.06, 0.6):
        want = jden(jnp.asarray(xs * sigma), jnp.float32(sigma))
        got = tden(nchw(xs * sigma), sigma)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-3)
