"""The port's `winograd=True` ADM torso against `kdip_tpu`'s, on the CPU: a
small float16 and bfloat16 UNet's forward and x-vjp against JAX's jitted
Winograd torso (the Pallas kernel and its custom VJPs in interpret mode),
the state dict, the float32 gate, and `config.make_openai_model`. Every
weight is random, carried from the flax tree by
`weights.from_jax_params`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu.models import adm as jadm
from kdip_tpu.utils import precast_inference_params
from test_torch_port import REPO, SMALL_UNET, nchw, nhwc, random_flax_params

S = SMALL_UNET["image_size"]
REPO_CONFIG = os.path.join(REPO, "configs", "test_ffhq.json")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    t = np.array([27.0], np.float32)
    ct = rng.standard_normal((1, S, S, 6)).astype(np.float32)
    return x, t, ct


def _port(params, winograd=True, dtype=torch.bfloat16):
    """The port's UNet with the flax tree's weights, pre-cast to `dtype`
    (GroupNorm float32) unless that is float32."""
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu", winograd=winograd)
    tm.load_state_dict(P.weights.from_jax_params(params))
    if dtype != torch.float32:
        P.weights.precast_inference(tm, dtype)
    return tm


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype,tol", [("float16", 2e-2), ("bfloat16", 0.1)])
def test_winograd_torso_matches_jax(dtype, tol):
    """The low-precision Winograd torso's output and x-vjp against
    kdip_tpu's (Pallas kernel and custom VJPs, interpret mode), relative
    to the largest value. Both run the same roundings in every Winograd
    conv (test_torch_winograd_ops), but the torso rounds at other places
    around them (XLA fuses elementwise chains in float32; kdip_tpu's
    decoder passes the skip pair split and chunks C at 128). In float16
    the frameworks agree to 0.7% (measured), so 2e-2 checks the fused
    prologue, the FiLM absorption, the up-blocks and the vjp through the
    affine (a vjp that drops da and db is 38% off). In bfloat16 even the
    two frameworks' direct torsos differ by 6.2% on this vjp (measured;
    the Winograd ones by 4.8% and 5.1%), so the bar is the bf16 torso
    drift of test_torch_unet.py::test_unet_bf16_torso_drift, 0.1."""
    x, t, ct = _inputs()
    jdt = getattr(jnp, dtype)
    jm = jadm.ADMUNet(**SMALL_UNET, dtype=jdt, winograd=True)
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t),
                                seed=6)
    pl = precast_inference_params(params, jdt)
    f = jax.jit(lambda xx: jm.apply({"params": pl}, xx, jnp.asarray(t)))
    y_j, vjp = jax.vjp(f, jnp.asarray(x))
    g_j = np.asarray(vjp(jnp.asarray(ct))[0])
    y_j = np.asarray(y_j)

    tm = _port(params, dtype=getattr(torch, dtype))
    P.ops.winograd.reset_launch_counts()
    xt = nchw(x).requires_grad_(True)
    y_t = tm(xt, torch.tensor(t))
    g_t, = torch.autograd.grad(y_t, xt, grad_outputs=nchw(ct))
    # on the CPU the wrapper takes the plain version and counts no launch
    assert sum(P.ops.winograd.launch_counts.values()) == 0
    assert np.abs(y_j).max() > 1e-2 and np.abs(g_j).max() > 1e-2
    assert _rel(nhwc(y_t), y_j) <= tol
    assert _rel(nhwc(g_t), g_j) <= tol


def test_winograd_flag_keeps_state_dict_and_f32_torso():
    """winograd=True changes no parameter name or shape (test_winograd.py:
    103-115, 142-143), and a float32 torso with the flag takes the direct
    path: it equals the plain float32 torso bit for bit, forward and vjp
    (test_winograd.py:201-221)."""
    x, t, ct = _inputs(1)
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t),
                                seed=7)
    on = _port(params, True, torch.float32)
    off = _port(params, False, torch.float32)
    assert on.winograd and not off.winograd
    sd_on, sd_off = on.state_dict(), off.state_dict()
    assert list(sd_on) == list(sd_off)
    assert all(torch.equal(sd_on[k], sd_off[k]) for k in sd_on)
    outs = []
    for m in (on, off):
        xt = nchw(x).requires_grad_(True)
        y = m(xt, torch.tensor(t))
        outs.append((y, *torch.autograd.grad(y, xt, nchw(ct))))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_make_openai_model_from_config():
    """config.make_openai_model on configs/test_ffhq.json builds ffhq_unet's
    topology (names and shapes) with the flag set, and the 1000-step
    linear tables; timestep_respacing respaces them; class_cond builds a
    label embedding of 1000 classes at the embedding width 4C."""
    cfg = P.config.load_config(REPO_CONFIG)
    model, tables = P.config.make_openai_model(
        cfg["model"], dtype=torch.bfloat16, winograd=True, device="cpu")
    ref = P.adm.ffhq_unet(dtype=torch.bfloat16, device="cpu")
    assert model.winograd and not ref.winograd
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    assert model.dtype == torch.bfloat16 and tables.num_timesteps == 1000
    blocks = [m for m in model.modules()
              if isinstance(m, P.layers.ResBlock)]
    assert len(blocks) == 30 and all(b.winograd for b in blocks)
    _, spaced = P.config.make_openai_model(
        {"openai": {"timestep_respacing": "100"}}, device="cpu")
    assert spaced.num_timesteps == 100
    assert spaced.timestep_map[:3].tolist() == [0, 10, 20]
    cond, _ = P.config.make_openai_model({"openai": {"class_cond": True}},
                                         device="meta")
    assert cond.label_emb.weight.shape == (1000, 4 * 128)
