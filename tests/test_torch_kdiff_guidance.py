"""The k-diffusion native variance model through the port's guidance,
sampler and CLI, against `kdip_tpu`, on the CPU in float32:
`guidance.make_kdiff_v2_uncond` on each side of the mle threshold, a
short Heun trajectory through `build_posterior_sampler(uncond_pair=)` in
the DWT and DCT bases with `kdip_tpu`'s draws injected, the k-diffusion
defaults that `config.load_config` merges (a config without `sigma_data`
reads 1.0), `config.make_model` / `make_denoiser_wrapper`, and the guided
CLI on an image_v2 and an image_v1 config beside `kdip_tpu`'s."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import kdip_tpu_torch as P
from kdip_tpu import config as jconfig
from kdip_tpu import diffusion as jd
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu import sampling_api as jsa
from kdip_tpu.cli import sample_condition as jcli
from kdip_tpu.ckpt import convert_kdiff_state_dict
from kdip_tpu_torch.cli import sample_condition as tcli
from test_torch_kdiff import close, randomize
from test_torch_port import REPO, nchw, nhwc
from test_torch_sampling import OP_CFG, SCFG, _jax_draws, N

S = 16
# an image_v2 "model" block as load_config merges it (augment_wrapper:
# 9 mapping inputs; sigma_data 1.0); three levels, channels <= 64
MODEL = {"type": "image_v2", "input_channels": 3, "input_size": [S, S],
         "sigma_min": 1e-2, "sigma_max": 80, "mapping_out": 32,
         "depths": [1, 1, 1], "channels": [32, 64, 64],
         "self_attn_depths": [False, True, False], "has_variance": True,
         "ortho_tf_type": "dwt"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's small CPU ops on one thread (see test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The port's model from `config.make_model` with seeded random
    weights, kdip_tpu's from its make_model, the params converted by
    kdip_tpu's converter, and both model_apply callables as the CLIs
    build them (9 zeros of mapping conditioning, return_variance)."""
    cfg = {"model": MODEL}
    torch.manual_seed(0)
    tm = randomize(P.config.make_model(P.config.load_config(cfg),
                                       device="cpu"), 3).eval()
    jm = jconfig.make_model(jconfig.load_config(cfg))
    params = convert_kdiff_state_dict(tm.state_dict(), 3)

    @jax.jit
    def japply(p, x, s):
        return jm.apply({"params": p}, x, s,
                        mapping_cond=jnp.zeros((x.shape[0], 9)),
                        return_variance=True)

    def tapply(x, s):
        return tm(x, s, mapping_cond=x.new_zeros(x.shape[0], 9),
                  return_variance=True)
    return tm, japply, tapply, params


@pytest.mark.parametrize("sigma", [0.5, 2.0], ids=["below", "above"])
def test_uncond_matches_each_side_of_threshold(models, sigma):
    """x0_mean (EDM c_skip, c_out, c_in at sigma_data 0.5) and the
    (x0_var, theta0_var) pair: the learned variances times c_out^2 below
    mle_sigma_thres 1.0, mle_var(sigma) above; float32 within 1e-5 of the
    largest value."""
    _, japply, tapply, params = models
    gcfg = dict(guidance="I", ortho_tf_type="dwt", mle_sigma_thres=1.0)
    ju, jv = jg.make_kdiff_v2_uncond(japply, jg.GuidanceConfig(**gcfg))
    tu, tv = P.guidance.make_kdiff_v2_uncond(
        tapply, P.guidance.GuidanceConfig(**gcfg))
    x = np.random.default_rng(4).standard_normal((2, S, S, 3),
                                                 dtype=np.float32)
    m_j, aux_j = ju(params, jnp.asarray(x), jnp.float32(sigma))
    with torch.no_grad():
        m_t, aux_t = tu(nchw(x), sigma)
    close(nhwc(m_t), m_j)
    v_j = jv(aux_j, jnp.float32(sigma))
    v_t = tv(aux_t, sigma)
    for a, b in zip(v_t, v_j):
        if sigma < 1.0:
            close(nhwc(a), b)
        else:
            assert a == pytest.approx(float(np.asarray(b).max()), rel=1e-6)


def test_sigma_data_defaults_to_one_after_the_merge(models):
    """A config without sigma_data: both packages' load_config merge
    k-diffusion's defaults, so the CLI's model_config.get("sigma_data",
    0.5) reads 1.0 in both, and the port's denoiser is kdip_tpu's at 1.0
    (and not the one at 0.5). Every other default merges as kdip_tpu's."""
    _, japply, tapply, params = models
    cfg = {"model": dict(MODEL), "dataset": {"location": "x"}}
    jc, tc = jconfig.load_config(cfg), P.config.load_config(cfg)
    assert tc == jc and "sigma_data" not in cfg["model"]
    assert tc["model"]["sigma_data"] == 1.0
    assert tc["model"]["augment_wrapper"] is True
    sd = tc["model"].get("sigma_data", 0.5)
    gcfg = dict(guidance="I", ortho_tf_type="dwt", mle_sigma_thres=1.0)
    ju, _ = jg.make_kdiff_v2_uncond(japply, jg.GuidanceConfig(**gcfg),
                                    sigma_data=jc["model"].get(
                                        "sigma_data", 0.5))
    tu, _ = P.guidance.make_kdiff_v2_uncond(
        tapply, P.guidance.GuidanceConfig(**gcfg), sigma_data=sd)
    half, _ = P.guidance.make_kdiff_v2_uncond(
        tapply, P.guidance.GuidanceConfig(**gcfg), sigma_data=0.5)
    x = np.random.default_rng(5).standard_normal((1, S, S, 3),
                                                 dtype=np.float32)
    with torch.no_grad():
        got, half_out = tu(nchw(x), 0.7)[0], half(nchw(x), 0.7)[0]
    close(nhwc(got), ju(params, jnp.asarray(x), jnp.float32(0.7))[0])
    assert (got - half_out).abs().max() > 1e-2


def test_make_model_and_denoiser_wrapper_match(models):
    """make_model builds V2 and V1 with the augment_wrapper's 9 extra
    mapping inputs (none without it), its errors are kdip_tpu's, and
    make_denoiser_wrapper gives kdip_tpu's (kind, sigma_data, ortho)."""
    tm = models[0]
    assert isinstance(tm, P.kdiff.ImageDenoiserModelV2)
    assert tm.mapping_cond.in_features == 9
    v1 = P.config.make_model(P.config.load_config(
        {"model": dict(MODEL, type="image_v1", augment_wrapper=False)}),
        device="cpu")
    assert isinstance(v1, P.kdiff.ImageDenoiserModelV1)
    assert not hasattr(v1, "mapping_cond")
    model, tables = P.config.make_model(P.config.load_config(
        {"model": {"type": "openai_ffhq", "openai": OPENAI}}),
        device="meta")
    assert isinstance(model, P.adm.ADMUNet) and tables.num_timesteps == 1000
    for bad in ("image_v3",):
        cfg = {"model": dict(MODEL, type=bad)}
        with pytest.raises(ValueError, match="Invalid denoiser type"):
            jconfig.make_model(jconfig.load_config(cfg))
        with pytest.raises(ValueError, match="Invalid denoiser type"):
            P.config.make_model(P.config.load_config(cfg), device="cpu")
    for extra in ({}, {"has_variance": True}, {"loss_config": "simple"},
                  {"sigma_data": 0.5, "ortho_tf_type": "dct"}):
        cfg = {"model": dict(dict(MODEL, has_variance=False), **extra)}
        assert P.config.make_denoiser_wrapper(P.config.load_config(cfg)) \
            == jconfig.make_denoiser_wrapper(jconfig.load_config(cfg))
    for extra, msg in (({"loss_config": "simple", "has_variance": True},
                        "simple loss"), ({"loss_config": "x"}, "Unknown")):
        cfg = P.config.load_config({"model": dict(MODEL, **extra)})
        with pytest.raises(ValueError, match=msg):
            jconfig.make_denoiser_wrapper(cfg)
        with pytest.raises(ValueError, match=msg):
            P.config.make_denoiser_wrapper(cfg)


@pytest.mark.parametrize("ortho", ["dwt", "dct"])
def test_heun_trajectory_matches(models, ortho):
    """build_posterior_sampler(uncond_pair=make_kdiff_v2_uncond(...)) on
    p=0.5 inpainting, Type-I with the learned covariance in the DWT or DCT
    basis, 4 Heun steps with churn from sigma_max 2 (the closed form above
    the threshold, CG below), 2 samples against one measurement, the
    initial x and churn noise replayed from kdip_tpu's key splits: the
    samples within 2e-3 and the worst CG residual within 0.1%, the bounds
    of test_torch_sampling.py's ADM trajectory, for the same reasons."""
    _, japply, tapply, params = models
    gcfg = dict(guidance="I", ortho_tf_type=ortho, mle_sigma_thres=1.0)
    jop = jo.get_operator(seed=1, **OP_CFG)
    top = P.operators.get_operator(seed=1, device="cpu", **OP_CFG)
    rng = np.random.RandomState(2)
    x0 = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    y = (x0 + 0.05 * rng.standard_normal(x0.shape).astype(np.float32)
         ) * np.asarray(jop.mask)

    jcfg = jg.GuidanceConfig(**gcfg)
    jsampler = jsa.build_posterior_sampler(
        japply, jd.make_diffusion(1000, "linear"), jop, jcfg,
        jsa.SamplerConfig(**SCFG), v2=True, image_size=S,
        uncond_pair=jg.make_kdiff_v2_uncond(japply, jcfg))
    key = jax.random.key(9)
    out_j, info_j = jax.jit(
        lambda p, m, k: jsampler(p, m, k, n=N, return_info=True))(
            params, jo.Measurement(y=jnp.asarray(y)), key)

    tcfg = P.guidance.GuidanceConfig(**gcfg)
    tsampler = P.sampling_api.build_posterior_sampler(
        None, P.diffusion.make_diffusion(1000, "linear", device="cpu"), top,
        tcfg, P.sampling_api.SamplerConfig(**SCFG), v2=True, image_size=S,
        device="cpu",
        uncond_pair=P.guidance.make_kdiff_v2_uncond(tapply, tcfg))
    init, churn = _jax_draws(key)
    out_t, info_t = tsampler(P.operators.Measurement(y=nchw(y)), n=N,
                             init_noise=init, noise_fn=churn.__getitem__,
                             return_info=True)
    assert out_t.shape == (N, 3, S, S) and torch.isfinite(out_t).all()
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=2e-3)
    r_j = float(info_j["cg_max_residual"])
    assert 0 < r_j <= 1e-4 and info_t["cg_total_iters"] > 0
    np.testing.assert_allclose(info_t["cg_max_residual"], r_j, rtol=1e-3)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_S = 32
OPENAI = {"num_channels": 32, "num_res_blocks": 1,
          "attention_resolutions": "16", "image_size": CLI_S,
          "num_head_channels": 16, "channel_mult": "1,2", "dropout": 0.0}


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """32 px: 2 test PNGs, an image_v2 config (DWT, no sigma_data) with a
    k-diffusion-named .pt of seeded random weights, an image_v1 config
    whose "openai" block makes a small ADM UNet with its guided-diffusion
    .pt, and an inpainting YAML."""
    root = tmp_path_factory.mktemp("kdiff_cli")
    (root / "val").mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray((rng.rand(CLI_S, CLI_S, 3) * 255).astype(np.uint8)
                        ).save(root / "val" / f"{i}.png")
    dataset = {"type": "imagefolder", "location": str(root / "val")}
    paths = {"root": str(root)}
    v2 = dict(MODEL, input_size=[CLI_S, CLI_S])
    v1 = {"type": "image_v1", "input_channels": 3,
          "input_size": [CLI_S, CLI_S], "sigma_min": 1e-2, "sigma_max": 80,
          "openai": OPENAI}
    for name, model in (("v2", v2), ("v1", v1)):
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump({"model": model, "dataset": dataset}, f)
    torch.manual_seed(1)
    kd = P.config.make_model(P.config.load_config({"model": v2}),
                             device="cpu")
    paths["v2_pt"] = str(root / "kdiff.pt")
    torch.save(randomize(kd, 6).state_dict(), paths["v2_pt"])
    unet = P.config.make_openai_model({"openai": OPENAI}, device="cpu")[0]
    paths["v1_pt"] = str(root / "adm.pt")
    torch.save(P.weights.randomize_(unet, 7).state_dict(), paths["v1_pt"])
    paths["op"] = str(root / "inpainting.yaml")
    with open(os.path.join(REPO, "configs", "inpainting_config.yaml")) as f:
        (root / "inpainting.yaml").write_text(
            f.read().replace("image_size: 256", f"image_size: {CLI_S}"))
    return paths


def _cli_args(env, which, logdir, *extra):
    return ["--checkpoint", env[f"{which}_pt"], "--config", env[which],
            "--operator-config", env["op"], "--logdir", str(logdir),
            "--steps", "3", "--max-images", "1", "--save-img", *extra]


def _artefacts(d):
    with open(d / "args.yaml") as f:
        args = yaml.safe_load(f)
    with open(d / "avg_metrics.yaml") as f:
        avg = yaml.safe_load(f)
    journal = [json.loads(ln) for ln in open(d / "metrics.jsonl")]
    return sorted(os.listdir(d)), args, avg, journal


@pytest.mark.parametrize("which", ["v2", "v1"])
def test_cli_matches_kdip_tpu(cli_env, tmp_path, which):
    """Both CLIs on the same flags (bf16, the CLI default, which the
    image_v2 model ignores: float32 throughout): the same files, args.yaml
    and run_cfg but for --device, the same metric keys, finite metrics and
    a CG residual at tolerance. image_v2 runs the k-diffusion model with
    the DWT basis from the config (no --v2) and the threshold 1.0;
    image_v1 takes the OpenAI branch in both, so its guided-diffusion .pt
    loads into the ADM UNet."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jcli.main(_cli_args(cli_env, which, jdir))
    if which == "v1":
        seen = []
        real = P.ckpt.load_strict

        def record(model, sd):
            seen.append(type(model))
            return real(model, sd)
        P.ckpt.load_strict = record
    try:
        tavg = tcli.main(_cli_args(cli_env, which, tdir, "--device", "cpu"))
    finally:
        if which == "v1":
            P.ckpt.load_strict = real
    if which == "v1":
        assert seen == [P.adm.ADMUNet]
    jfiles, jargs, javg, jj = _artefacts(jdir)
    tfiles, targs, tavg_saved, tj = _artefacts(tdir)
    assert tfiles == jfiles
    assert targs.pop("device") == "cpu"
    targs.pop("logdir"), jargs.pop("logdir")
    assert targs == jargs
    assert tj[0]["run_cfg"] == dict(jj[0]["run_cfg"], device="cpu")
    assert tj[1].keys() == jj[1].keys() == {"psnr", "ssim", "image"}
    assert tavg_saved.keys() == javg.keys()
    assert np.isfinite(tavg["psnr"]) and np.isfinite(javg["psnr"])
    for avg in (tavg, javg):
        assert 0 < avg["cg_max_residual"] <= 1e-4
