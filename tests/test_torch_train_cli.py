"""The port's two training CLIs on the CPU (`--device cpu`), at 32 px:
`kdip_tpu_torch.cli.analytic_variance` (its tables, `--per-sample-map`,
the `--resume` journal) and `kdip_tpu_torch.cli.train_openai` (its
artefacts, which `kdip_tpu`'s event reader and the port's `ckpt.load_v2`
read; a resume at an epoch boundary bit-equal to the uninterrupted run; a
resume mid-epoch restoring the whole state), and their refusals.

The CLIs' arithmetic is held to `kdip_tpu` by tests/test_torch_train.py
(losses, gradients, optimizer, analytic_variance) and
tests/test_torch_train_data.py (the images, batches and augmentation);
jax's and torch's draws differ, so here each CLI is held to its own
determinism and to `kdip_tpu`'s artefacts.
"""

import csv
import json
import os
import signal

import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import tfevents as jtfevents
from kdip_tpu_torch.cli import analytic_variance as acli
from kdip_tpu_torch.cli import sample_condition as scli
from kdip_tpu_torch.cli import train_openai as tcli
from test_torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 32
# tests/test_cli.py's sizes; configs/train_ffhq_dwt.json's training keys,
# with a_prob 0.5 so that the warp runs
MODEL_CFG = {
    "type": "openai_ffhq", "input_channels": 3, "input_size": [S, S],
    "augment_prob": 0.5, "sigma_min": 1e-2, "sigma_max": 80,
    "sigma_data": 0.5, "sigma_sample_density": {"type": "cosine"},
    "openai": {"num_channels": 32, "num_res_blocks": 1,
               "attention_resolutions": "16", "image_size": S,
               "num_head_channels": 16, "channel_mult": "1,2",
               "dropout": 0.0},
    "ortho_tf_type": "dwt"}


@pytest.fixture(scope="module")
def env(tmp_path_factory, one_torch_thread):
    """A random UNet .pt, a config, a folder of 4 PNGs (one 40 x 48, so
    the resize runs), a 1-image folder and its config."""
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.RandomState(0)
    for name, folder in (("data", 4), ("one", 1)):
        (root / name).mkdir()
        for i in range(folder):
            hw = (40, 48) if i == 3 else (S, S)
            P.data.write_png(root / name / f"{i}.png",
                             (rng.rand(*hw, 3) * 255).astype(np.uint8))
    paths = {"root": root}
    for name in ("data", "one"):
        paths[f"config_{name}"] = str(root / f"config_{name}.json")
        with open(paths[f"config_{name}"], "w") as f:
            json.dump({"model": MODEL_CFG,
                       "dataset": {"type": "imagefolder",
                                   "location": str(root / name)},
                       "ema_sched": {"power": 0.6667, "max_value": 0.9999}},
                      f)
    unet = P.config.make_openai_model(MODEL_CFG, device="cpu")[0]
    paths["pt"] = str(root / "model.pt")
    torch.save(P.weights.randomize_(unet, 0).state_dict(), paths["pt"])
    return paths


def _train(env, logdir, *extra):
    return tcli.main(["--config", env["config_data"], "--checkpoint",
                      env["pt"], "--batch-size", "2", "--device", "cpu",
                      "--logdir", str(logdir), "--num-workers", "0",
                      *extra])


def _analytic(env, logdir, *extra):
    return acli.main(["--config", env["config_data"], "--checkpoint",
                      env["pt"], "--num-sigmas", "4", "--batch-size", "2",
                      "--data-fraction", "1.0", "--dtype", "float32",
                      "--device", "cpu", "--logdir", str(logdir), *extra])


def _assert_states_equal(a, b):
    for x, y in ((a.model, b.model), (a.ema, b.ema)):
        for (k, p), q in zip(x.state_dict().items(),
                             y.state_dict().values()):
            assert torch.equal(p, q), k


def test_analytic_cli_writes_its_tables(env, tmp_path, monkeypatch):
    """4 Karras sigmas over 2 batches of 2 (the 4 images, one resized):
    recon_mse.npz and recon_mse.pt hold the same float32 table, which the
    guided CLI's reader takes; --per-sample-map (batch-1 forwards on the
    same noise) gives it within 1e-5 relative (float32 convs at batch 1
    and 2); a --resume rerun reads every sigma from the journal, runs no
    UNet forward and writes the same table bit for bit."""
    out = _analytic(env, tmp_path / "a", "--resume")
    with np.load(tmp_path / "a" / "recon_mse.npz") as npz:
        assert sorted(npz.files) == ["errors", "mse_list", "sigmas"]
        for k in npz.files:
            assert npz[k].dtype == np.float32 and npz[k].shape == (4,)
            np.testing.assert_array_equal(npz[k], out[k].numpy())
    table = scli._recon_mse(str(tmp_path / "a" / "recon_mse.pt"))
    np.testing.assert_array_equal(table["mse_list"], out["mse_list"].numpy())
    assert np.all(np.diff(out["sigmas"].numpy()) < 0)
    assert np.all(out["mse_list"].numpy() > 0)
    psm = _analytic(env, tmp_path / "b", "--per-sample-map")
    for k in ("mse_list", "errors"):
        np.testing.assert_allclose(psm[k].numpy(), out[k].numpy(),
                                   rtol=1e-5, err_msg=k)
    calls = []
    forward = P.adm.ADMUNet.forward
    monkeypatch.setattr(P.adm.ADMUNet, "forward",
                        lambda self, *a, **k: calls.append(1)
                        or forward(self, *a, **k))
    again = _analytic(env, tmp_path / "a", "--resume")
    assert calls == []
    for k in out:
        assert torch.equal(again[k], out[k]), k


def test_train_cli_writes_its_artefacts(env, tmp_path):
    """Two steps at batch 2 (per_sample_map on, the default; a thread
    pool of 2), saving at step 2 with a preview: train_log.csv (its
    header row, step 1's row), the tb/ event file (kdip_tpu's reader gets
    train/loss and train/ema_decay at step 1), state_2.pt (the EMA
    weights under the reference's names, which ckpt.load_v2 loads into an
    ADMUNetV2), train_state_latest.pt (step 2, the model, EMA, Adam state
    and EMA schedule) and preview_2.png (4 samples side by side)."""
    log = tmp_path / "t"
    state = _train(env, log, "--max-steps", "2", "--save-every", "2",
                   "--num-workers", "2", "--preview-every", "2",
                   "--preview-steps", "3")
    assert state.step == 2
    with open(log / "train_log.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["step", "loss", "ema_decay", "time"]
    assert [r[0] for r in rows[1:]] == ["1"] and np.isfinite(float(rows[1][1]))
    tb, = os.listdir(log / "tb")
    events = jtfevents.read_events(str(log / "tb" / tb))
    assert events[1][1] == 1
    assert set(events[1][2]) == {"train/loss", "train/ema_decay"}
    v2 = P.adm.ADMUNetV2(P.config.make_openai_model(MODEL_CFG,
                                                    device="cpu")[0])
    P.ckpt.load_v2(v2, P.ckpt.load_torch_checkpoint(str(log / "state_2.pt")))
    for k, v in v2.state_dict().items():
        assert torch.equal(v, state.ema.state_dict()[k]), k
    saved = P.ckpt.load_checkpoint(str(log / "train_state_latest.pt"))
    assert saved["ema_sched_last_epoch"] == 2
    assert saved["train_state"]["step"] == 2
    assert len(saved["train_state"]["optimizer"]["state"]) == len(
        state.params)
    assert P.data.read_png(log / "preview_2.png").shape == (S, 4 * S, 3)


def test_resume_at_an_epoch_boundary_is_bit_equal(env, tmp_path):
    """4 images at batch 2 make 2-step epochs: 2 steps, then --resume to
    4, equal an uninterrupted 4-step run bit for bit, the model and the
    EMA (the draws of step s come from [seed, s], the batches of the
    epoch that starts at step s are shuffled with seed + s, and the Adam
    state and EMA schedule are restored)."""
    whole = _train(env, tmp_path / "whole", "--max-steps", "4",
                   "--save-every", "2")
    _train(env, tmp_path / "parts", "--max-steps", "2", "--save-every", "2")
    resumed = _train(env, tmp_path / "parts", "--max-steps", "4",
                     "--save-every", "2", "--resume")
    assert resumed.step == whole.step == 4
    _assert_states_equal(resumed, whole)


def test_resume_mid_epoch_restores_the_state(env, tmp_path, monkeypatch):
    """3 steps at --accum 2 (mid-epoch, one gradient in the accumulator),
    then --resume: with --max-steps 3 the state comes back exactly (model,
    EMA, Adam moments, the accumulator and its mini-step); with 4, the
    first step runs at the EMA decay of step 3 (the warmup fast-forwarded)."""
    log = tmp_path / "m"
    first = _train(env, log, "--max-steps", "3", "--save-every", "3",
                   "--accum", "2")
    assert first.mini_step == 1
    back = _train(env, log, "--max-steps", "3", "--accum", "2", "--resume")
    assert back.step == 3 and back.mini_step == 1
    _assert_states_equal(back, first)
    for a, b in zip(back.acc_grads, first.acc_grads):
        assert torch.equal(a, b)
    for p, q in zip(back.params, first.params):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(back.optimizer.state[p][key],
                               first.optimizer.state[q][key]), key
    decays = []
    make = P.train.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)
        return lambda s, b, decay, **kw: decays.append(decay) or step(
            s, b, decay, **kw)
    monkeypatch.setattr(P.train, "make_train_step", recording)
    _train(env, log, "--max-steps", "4", "--accum", "2", "--resume")
    sched = P.utils.EMAWarmup(power=0.6667, max_value=0.9999, last_epoch=3)
    assert decays == [sched.get_value()] and decays[0] > 0


def test_sigterm_saves_and_stops(env, tmp_path, monkeypatch, capsys):
    """A SIGTERM during step 1 of 3 (a preemption) lets the step finish,
    then the CLI saves state_1.pt and train_state_latest.pt at step 1,
    prints "preempted at step 1" and returns; the caller's SIGTERM handler
    is back in place afterwards."""
    make = P.train.make_train_step

    def terminating(*a, **k):
        step = make(*a, **k)

        def run(*sa, **skw):
            os.kill(os.getpid(), signal.SIGTERM)
            return step(*sa, **skw)
        return run
    monkeypatch.setattr(P.train, "make_train_step", terminating)
    before = signal.getsignal(signal.SIGTERM)
    state = _train(env, tmp_path / "p", "--max-steps", "3")
    assert state.step == 1
    assert "preempted at step 1" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "p" / "state_1.pt")
    saved = P.ckpt.load_checkpoint(str(tmp_path / "p" /
                                       "train_state_latest.pt"))
    assert saved["train_state"]["step"] == 1
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("case", ["orbax_checkpoint", "orbax_resume",
                                  "too_few_images", "analytic_orbax",
                                  "no_card"])
def test_refusals(env, tmp_path, case, monkeypatch):
    """kdip_tpu's orbax directories (a --checkpoint, a train_state_latest
    for --resume) are refused, as is a folder with fewer images than a
    batch (with drop_last no step would ever run) and --device cuda
    without a card; each a SystemExit naming what is wrong."""
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    if case == "orbax_checkpoint":
        argv = ["--checkpoint", str(orbax)]
    elif case == "orbax_resume":
        (tmp_path / "t").mkdir()
        (tmp_path / "t" / "train_state_latest").mkdir()
        argv = ["--resume"]
    elif case == "too_few_images":
        argv = ["--config", env["config_one"]]
    elif case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = ["--device", "cuda"]
    if case == "analytic_orbax":
        with pytest.raises(SystemExit, match="orbax"):
            _analytic(env, tmp_path / "a", "--checkpoint", str(orbax))
        return
    with pytest.raises(SystemExit, match={
            "orbax_checkpoint": "orbax", "orbax_resume": "orbax",
            "too_few_images": "fewer than --batch-size",
            "no_card": "no CUDA card"}[case]):
        _train(env, tmp_path / "t", "--max-steps", "1", *argv)
