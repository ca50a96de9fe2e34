"""The port's guided-sampling CLI (`kdip_tpu_torch.cli.sample_condition`), its
checkpoint loading (`kdip_tpu_torch.ckpt`) and its YAML subset
(`kdip_tpu_torch.config.load_yaml` / `save_yaml`) against `kdip_tpu`, at
32 px, 3 steps, on the CPU (`--device cpu`).

jax's and torch's random draws differ, so the CLI as a whole is held to
`kdip_tpu`'s artefacts and keys, to its own determinism and resume, and to
`kdip_tpu.metrics` recomputed on its own samples; the sampler under it is
held by tests/test_torch_sampling.py.
"""

import argparse
import glob
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from kdip_tpu import ckpt as jckpt
from kdip_tpu import metrics as jmetrics
from kdip_tpu.cli import sample_condition as jcli
from kdip_tpu.models import adm as jadm
from kdip_tpu_torch import ckpt as tckpt
from kdip_tpu_torch import config as tconfig
from kdip_tpu_torch import metrics as tmetrics
from kdip_tpu_torch import weights as tweights
from kdip_tpu_torch.cli import sample_condition as tcli
from kdip_tpu_torch.models import adm as tadm
from test_torch_metrics import random_lpips_params
from test_torch_port import REPO, SMALL_UNET, nchw, nhwc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Runs this file's small CPU ops on one thread: under the suite's
    parallel workers, torch's per-op thread pools oversubscribe the cores
    and tiny ops slow down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

S = 32
UNET = dict(SMALL_UNET, image_size=S)
MODEL_CFG = {
    "type": "openai_ffhq", "input_channels": 3, "input_size": [S, S],
    "sigma_min": 1e-2, "sigma_max": 80,
    "openai": {"num_channels": 32, "num_res_blocks": 1,
               "attention_resolutions": "16", "image_size": S,
               "num_head_channels": 16, "channel_mult": "1,2",
               "dropout": 0.0}}


def _v2_state_dict(seed):
    m = tadm.ADMUNetV2(tconfig.make_openai_model(MODEL_CFG, device="cpu")[0])
    return tweights.randomize_(m, seed).state_dict()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A 32 px FFHQ-like setup: a random UNet .pt, Lightning DWT-Var
    checkpoints, the model configs, an inpainting YAML, 3 test images and
    random LPIPS weights in kdip_tpu's npz."""
    root = tmp_path_factory.mktemp("torch_cli")
    (root / "val").mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray((rng.rand(S, S, 3) * 255).astype(np.uint8)).save(
            root / "val" / f"{i}.png")
    dataset = {"type": "imagefolder", "location": str(root / "val")}
    paths = {}
    for name, extra in (("config", {}), ("config_dwt",
                                         {"ortho_tf_type": "dwt"})):
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump({"model": dict(MODEL_CFG, **extra),
                       "dataset": dataset}, f)
    unet = tconfig.make_openai_model(MODEL_CFG, device="cpu")[0]
    paths["pt"] = str(root / "model.pt")
    torch.save(tweights.randomize_(unet, 0).state_dict(), paths["pt"])
    ema, raw = _v2_state_dict(1), _v2_state_dict(2)
    sd = {f"model_ema.{k}": v for k, v in ema.items()}
    sd.update({f"model.{k}": v for k, v in raw.items()})
    sd["model_ema.sigmas"] = torch.linspace(0.01, 80, 10)  # not a weight
    paths["ckpt_ema"] = str(root / "v2_ema.ckpt")
    torch.save({"state_dict": sd, "epoch": 3}, paths["ckpt_ema"])
    paths["ckpt_model"] = str(root / "v2_model.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in raw.items()}},
               paths["ckpt_model"])
    # Lightning's usual top-level keys beside the EMA weights, with
    # hyper_parameters holding objects beyond tensors and plain containers
    paths["ckpt_lightning"] = str(root / "v2_lightning.ckpt")
    torch.save({
        "epoch": 3, "global_step": 1200, "pytorch-lightning_version": "2.1.0",
        "state_dict": sd,
        "hyper_parameters": {"args": argparse.Namespace(
            lr=1e-4, config=pathlib.Path("configs/test_ffhq_dwt.json"))},
        "hparams_name": "kwargs",
        "optimizer_states": [{"state": {0: {"step": torch.tensor(1200.0),
                                            "exp_avg": torch.zeros(3)}},
                              "param_groups": [{"lr": 1e-4,
                                                "betas": (0.9, 0.999),
                                                "params": [0]}]}],
        "lr_schedulers": [],
        "callbacks": {"ModelCheckpoint{'monitor': None}": {
            "dirpath": "ckpts", "best_model_score": None,
            "kth_value": torch.tensor(float("inf"))}},
        "loops": {"fit_loop": {"epoch_progress": {"total": {"ready": 4}}}},
    }, paths["ckpt_lightning"])
    paths["op"] = str(root / "inpainting.yaml")
    with open(os.path.join(REPO, "configs", "inpainting_config.yaml")) as f:
        (root / "inpainting.yaml").write_text(
            f.read().replace("image_size: 256", f"image_size: {S}"))
    paths["lpips"] = str(root / "lpips.npz")
    np.savez(paths["lpips"], params=np.array(random_lpips_params(4),
                                             dtype=object))
    paths["root"] = str(root)
    return paths


def _args(env, logdir, *extra, config="config", checkpoint="pt"):
    return ["--checkpoint", env[checkpoint], "--config", env[config],
            "--operator-config", env["op"], "--logdir", str(logdir),
            "--steps", "3", "--dtype", "float32", *extra]


def run(env, logdir, *extra, **kw):
    """The port's CLI on the CPU; returns (avg, journal lines)."""
    avg = tcli.main(_args(env, logdir, *extra, "--device", "cpu", **kw))
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return avg, [json.loads(ln) for ln in f]


def test_artefacts_and_keys_match_kdip_tpu(env, tmp_path):
    """The same flags through both CLIs: the same files in the log dir,
    args.yaml with kdip_tpu's keys and values plus --device, the journal's
    run_cfg header likewise, the same per-image and average keys."""
    flags = ("--max-images", "1", "--save-img", "--lpips-weights",
             env["lpips"])
    jcli.main(_args(env, tmp_path / "jax", *flags))
    run(env, tmp_path / "torch", *flags)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))

    def load(d, name):
        with open(d / name) as f:
            return yaml.safe_load(f)
    ja, ta = load(jdir, "args.yaml"), load(tdir, "args.yaml")
    assert ta.pop("device") == "cpu"
    assert ta.pop("logdir") == str(tdir) and ja.pop("logdir") == str(jdir)
    assert ta == ja
    jj = [json.loads(ln) for ln in open(jdir / "metrics.jsonl")]
    tj = [json.loads(ln) for ln in open(tdir / "metrics.jsonl")]
    assert tj[0]["run_cfg"] == dict(jj[0]["run_cfg"], device="cpu")
    assert [r.keys() for r in tj[1:]] == [r.keys() for r in jj[1:]]
    assert tj[1].keys() == {"psnr", "ssim", "lpips", "image"}
    javg, tavg = load(jdir, "avg_metrics.yaml"), load(tdir, "avg_metrics.yaml")
    assert tavg.keys() == javg.keys() >= {"psnr", "ssim", "lpips",
                                          "lpips_note", "cg_max_residual",
                                          "wall_clock_per_image"}
    assert "lpips_from_jax_params" in tavg["lpips_note"]
    for d in (jdir, tdir):
        png = np.asarray(Image.open(d / "out_img_0_hat_x0_sample_0.png"))
        assert png.shape == (S, S, 3) and png.dtype == np.uint8


def test_seed_determinism(env, tmp_path):
    """The same --seed gives identical metrics, another seed others."""
    _, a = run(env, tmp_path / "a", "--max-images", "2")
    _, b = run(env, tmp_path / "b", "--max-images", "2")
    _, c = run(env, tmp_path / "c", "--max-images", "2", "--seed", "1")
    assert len(a) == 3 and a[1:] == b[1:]
    assert all(x["psnr"] != y["psnr"] for x, y in zip(a[1:], c[1:]))


def test_resume_reproduces_and_refuses_changed_settings(env, tmp_path):
    """--max-images 1, then --resume --max-images 2, journals exactly the
    metrics of an uninterrupted --max-images 2 run; a --resume with other
    sampling settings is refused."""
    _, full = run(env, tmp_path / "full", "--max-images", "2")
    run(env, tmp_path / "part", "--max-images", "1")
    avg, part = run(env, tmp_path / "part", "--max-images", "2", "--resume")
    assert part == full
    assert avg["psnr"] == (full[1]["psnr"] + full[2]["psnr"]) / 2
    with pytest.raises(SystemExit, match="--resume refused"):
        run(env, tmp_path / "part", "--max-images", "2", "--resume",
            "--steps", "2")


def test_v2_dwt_var_and_spatial_var(env, tmp_path):
    """--v2 on the DWT-Var config (CG through the DWT covariance) and
    --v2 --spatial-var (no transform) run from a Lightning checkpoint."""
    for name, extra in (("dwt", ()), ("spatial", ("--spatial-var",))):
        avg, rows = run(env, tmp_path / name, "--v2", "--max-images", "1",
                        *extra, config="config_dwt", checkpoint="ckpt_ema")
        assert len(rows) == 2 and np.isfinite(avg["psnr"])
        assert 0 < avg["cg_max_residual"] <= 1e-4


@pytest.mark.parametrize("flags", [
    ("--xstart-cov-type", "analytic", "--ode"),
    ("--xstart-cov-type", "analytic", "--guidance", "II"),
    ("--guidance", "dps", "--xstart-cov-type", "dps", "--zeta", "1.0",
     "--ode"),
    ("--sampler", "dpmpp_2m",),
    ("--euler", "--cg-maxiter", "5"),
    ("--dtype", "bfloat16", "--winograd", "-n", "2"),
], ids=["analytic-npz", "analytic-pt-II", "dps", "dpmpp_2m", "euler",
        "bf16-winograd-n2"])
def test_sampling_flags_reach_the_sampler(env, tmp_path, flags):
    """The covariance, guidance, sampler, CG and torso flags map to the
    port's GuidanceConfig / SamplerConfig and run (a later --dtype
    overrides _args' float32): analytic reads the config's recon_mse
    table from an .npz or a torch file."""
    sigmas = np.geomspace(1e-2, 80.0, 16).astype(np.float32)
    table = {"sigmas": sigmas,
             "mse_list": 0.5 * sigmas ** 2 / (1 + sigmas ** 2)}
    mse = str(tmp_path / ("mse.pt" if "II" in flags else "mse.npz"))
    if mse.endswith(".npz"):
        np.savez(mse, **table)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in table.items()}, mse)
    cfg = str(tmp_path / "config.json")
    with open(env["config"]) as f:
        doc = json.load(f)
    doc["model"]["recon_mse"] = mse
    with open(cfg, "w") as f:
        json.dump(doc, f)
    argv = _args(env, tmp_path / "run", "--max-images", "1", *flags,
                 "--device", "cpu")
    argv[argv.index(env["config"])] = cfg
    avg = tcli.main(argv)
    assert np.isfinite(avg["psnr"]) and np.isfinite(avg["ssim"])


@pytest.mark.parametrize("case", ["dp", "orbax", "no_card",
                                  "batch_with_n"])
def test_refusals(env, tmp_path, case, monkeypatch):
    """What the port does not run exits with a message that says why: --dp
    without a process group to join (no launcher's environment) names
    torchrun, an orbax directory is refused, --device cuda without a card
    never falls back to the CPU, --batch-size > 1 needs -n 1. (--dp over
    two ranks: test_torch_parallel_ranks.py; the k-diffusion native models
    run: test_torch_kdiff_guidance.py.)"""
    logdir = tmp_path / "x"
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "OMPI_COMM_WORLD_SIZE", "SLURM_JOB_ID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    argv, match = {
        "dp": (_args(env, logdir, "--dp", "--device", "cpu"),
               "--dp needs a process group: launch with torchrun"),
        "orbax": (_args(env, logdir, "--device", "cpu",
                        checkpoint="root"), "orbax"),
        "no_card": (_args(env, logdir), "no CUDA card"),
        "batch_with_n": (_args(env, logdir, "--device", "cpu",
                               "--batch-size", "2", "-n", "2"), "-n 1"),
    }[case]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv)
    assert not (logdir / "metrics.jsonl").exists()


def test_journal_metrics_match_kdip_tpu(env, tmp_path, monkeypatch):
    """Each journaled metric equals kdip_tpu.metrics.compute_metrics on the
    port's own hat_x0 and x0: psnr within 1e-4 dB, ssim within 1e-12,
    lpips within 1e-5 relative (tests/test_torch_metrics.py)."""
    seen = []
    real = tmetrics.compute_metrics

    def record(hat_x0, x0, lpips_params=None):
        out = real(hat_x0, x0, lpips_params)
        seen.append((nhwc(hat_x0), nhwc(x0), out))
        return out
    monkeypatch.setattr(tmetrics, "compute_metrics", record)
    _, rows = run(env, tmp_path / "m", "--max-images", "2",
                  "--lpips-weights", env["lpips"])
    params = random_lpips_params(4)
    assert len(seen) == 2
    for (hat, x0, out), row in zip(seen, rows[1:]):
        assert row == dict(out, image=row["image"])
        want = jmetrics.compute_metrics(jnp.asarray(hat), jnp.asarray(x0),
                                        params)
        assert abs(row["psnr"] - want["psnr"]) <= 1e-4
        assert abs(row["ssim"] - want["ssim"]) <= 1e-12
        assert abs(row["lpips"] - want["lpips"]) <= 1e-5 * want["lpips"]


def test_keyboard_interrupt_saves_partial_averages(env, tmp_path,
                                                   monkeypatch):
    """An interrupt during the second image keeps the first: its journal
    line and avg_metrics.yaml over it."""
    real, calls = tmetrics.compute_metrics, []

    def interrupt(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*a, **kw)
    monkeypatch.setattr(tmetrics, "compute_metrics", interrupt)
    avg, rows = run(env, tmp_path / "k", "--max-images", "3")
    assert len(rows) == 2 and avg["psnr"] == rows[1]["psnr"]
    saved = tconfig.load_yaml(str(tmp_path / "k" / "avg_metrics.yaml"))
    assert saved["psnr"] == avg["psnr"]


def test_batch_size_pads_the_last_batch(env, tmp_path):
    """--batch-size 2 over 3 images: two sampler calls, the second padded,
    one journal line per image; --cg-warm-start reports its iterations."""
    avg, rows = run(env, tmp_path / "b", "--batch-size", "2",
                    "--cg-warm-start")
    assert [r["image"] for r in rows[1:]] == [0, 1, 2]
    assert avg["cg_total_iters"] > 0 and np.isfinite(avg["psnr"])


@pytest.mark.parametrize("which", ["pt", "ckpt_ema", "ckpt_model",
                                   "ckpt_lightning"])
def test_checkpoint_loads_match_kdip_tpu(env, which):
    """A guided-diffusion .pt and Lightning DWT-Var .ckpt files (EMA
    weights first, else model.; one with Lightning's hyper_parameters,
    optimizer states, callbacks and loops) load into the port's UNet as
    kdip_tpu's converters load them: outputs within 1e-5 on the same
    input."""
    sd = tckpt.load_torch_checkpoint(env[which])
    jsd = jckpt.load_torch_checkpoint(env[which])
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    t = np.array([10.5, 700.25], np.float32)
    unet = tconfig.make_openai_model(MODEL_CFG, device="cpu")[0]
    if which == "pt":
        model = tckpt.load_strict(unet, sd)
        jm, params = jadm.ADMUNet(**UNET), jckpt.convert_adm_state_dict(jsd)
    else:
        model = tckpt.load_v2(tadm.ADMUNetV2(unet), sd)
        prefix = "model." if which == "ckpt_model" else "model_ema."
        inner = jckpt.strip_prefix(jsd, prefix)
        jm = jadm.ADMUNetV2(unet=jadm.ADMUNet(**UNET))
        params = {"unet": jckpt.convert_adm_state_dict(
            jckpt.strip_prefix(inner, "inner_model.")),
            "out_cov": jckpt.convert_v2_out_cov(inner)}
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(t))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    if which == "pt":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-5)


def test_strict_loading_fails_loudly(env):
    """A misnamed or missing key raises in both loaders."""
    sd = dict(tckpt.load_torch_checkpoint(env["pt"]))
    sd["out.2.wieght"] = sd.pop("out.2.weight")
    unet = tconfig.make_openai_model(MODEL_CFG, device="cpu")[0]
    with pytest.raises(RuntimeError, match="out.2.w"):
        tckpt.load_strict(unet, sd)
    v2 = dict(tckpt.load_torch_checkpoint(env["ckpt_model"]))
    del v2["model.out_cov.bias"]
    with pytest.raises(RuntimeError, match="bias"):
        tckpt.load_v2(tadm.ADMUNetV2(unet), v2)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    REPO, "configs", "*.yaml"))), ids=os.path.basename)
def test_load_yaml_matches_pyyaml(path):
    with open(path) as f:
        assert tconfig.load_yaml(path) == yaml.safe_load(f)


def test_save_yaml_reads_back_unchanged(tmp_path):
    """What save_yaml writes, yaml.safe_load and load_yaml read back
    unchanged: the CLI's args and metrics, every scalar kind. A nested
    map, which no artefact holds, is refused."""
    data = {"a": 1, "b": 1e-5, "c": "x: y # z \"q\" \u00e9", "d": None,
            "e": True, "f": [1, 2.5, "s"], "i": "../m.pt",
            "j": 1e20, "k": -3.0, "l": float("inf"), "m": [], "n": "",
            "o": 123456789.123, "p": 5.558234988711774e-06}
    data.update(vars(tcli.build_argparser().parse_args([])))
    path = str(tmp_path / "a.yaml")
    tconfig.save_yaml(data, path)
    with open(path) as f:
        assert yaml.safe_load(f) == data
    assert tconfig.load_yaml(path) == data
    with pytest.raises(ValueError, match="cannot write a dict"):
        tconfig.save_yaml({"g": {"h": 0.1}}, path)


@pytest.mark.parametrize("text", [
    "a: 1e-5", "a: yes", "a: [1e-5]", "a:\n  b:\n    c: 1", "a: {x: 1}",
    "a: .5", "\ta: 1", "a: 1\n  b: 2", "a: [[1]]", "a 1", "a: 1\na: 2",
    "a: - b"])
def test_load_yaml_refuses_outside_the_subset(tmp_path, text):
    """Anything past the subset raises a ValueError that names the line."""
    path = tmp_path / "bad.yaml"
    path.write_text(text + "\n")
    with pytest.raises(ValueError, match=r"bad\.yaml:\d"):
        tconfig.load_yaml(str(path))
