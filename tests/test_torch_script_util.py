"""The port's `script_util` against `kdip_tpu.script_util`, on the CPU: every
defaults dict, the argparse bridges, and each factory at reduced width,
its model's float32 output against `kdip_tpu`'s on the same seeded
weights (carried by `weights.from_jax_params` or `kdip_tpu`'s classifier
converter) and its DiffusionSpec against `kdip_tpu`'s."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import ckpt as jckpt
from kdip_tpu import script_util as js
from kdip_tpu_torch import script_util as ts
from test_torch_adm_rest import close
from test_torch_port import nchw, nhwc, random_flax_params

DEFAULTS = ["diffusion_defaults", "classifier_defaults",
            "model_and_diffusion_defaults",
            "classifier_and_diffusion_defaults",
            "sr_model_and_diffusion_defaults"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's small CPU ops on one thread (see test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", DEFAULTS)
def test_defaults_equal_kdip_tpu(name):
    assert getattr(ts, name)() == getattr(js, name)()


def test_argparse_bridges():
    """add_dict_to_argparser / args_to_dict / str2bool parse as kdip_tpu's."""
    argv = ["--image_size", "128", "--class_cond", "yes",
            "--timestep_respacing", "ddim25", "--dropout", "0.1"]
    got = []
    for mod in (ts, js):
        p = argparse.ArgumentParser()
        d = mod.model_and_diffusion_defaults()
        mod.add_dict_to_argparser(p, d)
        got.append(mod.args_to_dict(p.parse_args(argv), d.keys()))
    assert got[0] == got[1] and got[0]["class_cond"] is True
    for v in ("yes", "T", "1", "no", "f", "0", True):
        assert ts.str2bool(v) == js.str2bool(v)
    with pytest.raises(argparse.ArgumentTypeError):
        ts.str2bool("maybe")


def spec_equal(got: ts.DiffusionSpec, want: js.DiffusionSpec):
    """The switches, and every table as kdip_tpu computes it (float64
    numpy, stored float32 in both)."""
    assert got[1:] == tuple(want[1:])
    for name in want.tables._fields:
        np.testing.assert_array_equal(
            getattr(got.tables, name).numpy(),
            np.asarray(getattr(want.tables, name)), err_msg=name)


# reduced widths: 16-32 px, 32 channels, one res block
MODEL = dict(js.model_and_diffusion_defaults(), image_size=16,
             num_channels=32, num_res_blocks=1, channel_mult="1,2",
             attention_resolutions="8", learn_sigma=True, class_cond=True,
             timestep_respacing="ddim10", use_kl=True)
SR = dict(js.sr_model_and_diffusion_defaults(), large_size=64,
          small_size=32, num_channels=32, num_res_blocks=1,
          attention_resolutions="16", resblock_updown=True,
          predict_xstart=True)
CLS = dict(js.classifier_and_diffusion_defaults(), classifier_width=32,
           classifier_depth=1, classifier_attention_resolutions="8",
           rescale_learned_sigmas=True)


def test_create_model_and_diffusion_matches():
    """The class-conditional, learned-sigma UNet of the defaults (no
    resblock up/down, one head count), respaced ddim10 with the KL loss."""
    tm, tspec = ts.create_model_and_diffusion(**MODEL, device="cpu")
    jm, jspec = js.create_model_and_diffusion(**MODEL)
    spec_equal(tspec, jspec)
    assert tspec.loss_type == "rescaled_kl" and \
        tspec.tables.num_timesteps == 10
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    t = np.array([3, 8])
    y = np.array([5, 999])
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(y), seed=1)
    tm.load_state_dict(P.weights.from_jax_params(params))
    want = jax.jit(lambda a: jm.apply({"params": params}, a, jnp.asarray(t),
                                      jnp.asarray(y)))(jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(t), y=torch.from_numpy(y))
    assert got.shape == (2, 6, 16, 16)
    close(nhwc(got), want)


def test_sr_create_model_and_diffusion_matches():
    """The 64 px super-resolution UNet (6 input channels, resblock
    up/down) on a 32 px low-res image, predict_xstart."""
    tm, tspec = ts.sr_create_model_and_diffusion(**SR, device="cpu")
    jm, jspec = js.sr_create_model_and_diffusion(**SR)
    spec_equal(tspec, jspec)
    assert isinstance(tm, P.adm.SuperResADMUNet)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 64, 64, 3), dtype=np.float32)
    low = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    t = np.array([500])
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(low), seed=3)
    tm.load_state_dict(P.weights.from_jax_params(params["unet"]))
    want = jax.jit(lambda a, b: jm.apply({"params": params}, a,
                                         jnp.asarray(t), low_res=b))(
        jnp.asarray(x), jnp.asarray(low))
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(t), low_res=nchw(low))
    close(nhwc(got), want)


def test_create_classifier_and_diffusion_matches():
    """The 64 px attention-pool classifier of the defaults at width 32,
    1000 classes, with the rescaled-MSE spec."""
    tm, tspec = ts.create_classifier_and_diffusion(**CLS, device="cpu")
    jm, jspec = js.create_classifier_and_diffusion(**CLS)
    spec_equal(tspec, jspec)
    assert tspec.loss_type == "rescaled_mse"
    P.weights.randomize_(tm, 4)
    params = jckpt.convert_classifier_state_dict(tm.state_dict(),
                                                 pool="attention")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 64, 64, 3), dtype=np.float32)
    t = np.array([100])
    want = jax.jit(lambda a: jm.apply({"params": params}, a,
                                      jnp.asarray(t)))(jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(t))
    assert got.shape == (1, 1000)
    close(got.numpy(), want)


def test_create_model_presets_and_fp16():
    """The image-size presets of channel_mult, an unknown size's error,
    and use_fp16's bfloat16 torso (float32 GroupNorm), on the meta
    device."""
    m = ts.create_model(256, 32, 1, device="meta")
    assert len(m.input_blocks) == 1 + 6 + 5
    with pytest.raises(ValueError, match="no channel multiplier preset"):
        ts.create_model(48, 32, 1, device="meta")
    with pytest.raises(ValueError, match="no channel multiplier preset"):
        js.create_model(48, 32, 1)
    h = ts.create_model(64, 32, 1, use_fp16=True, device="meta")
    assert h.dtype == torch.bfloat16
    assert h.out[0].weight.dtype == torch.float32
