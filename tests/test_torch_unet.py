"""The port's ADM UNet (`kdip_tpu_torch.models.adm`) against `kdip_tpu`'s:
forward and x-vjp in float32, the bfloat16 torso, and the state-dict names.
Every weight is random, carried from the flax tree by
`weights.from_jax_params`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu import ckpt
from kdip_tpu.models import adm as jadm
from kdip_tpu.utils import precast_inference_params
from kdip_tpu_torch import weights
from kdip_tpu_torch.models import adm as tadm
from kdip_tpu_torch.models.layers import GroupNorm32
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params

S = SMALL_UNET["image_size"]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    t = np.array([10.5, 500.25], np.float32)  # fractional, as V2 passes
    ct = rng.standard_normal((2, S, S, 6)).astype(np.float32)
    return x, t, ct


def _pair(new_order=False):
    kw = dict(SMALL_UNET, use_new_attention_order=new_order)
    jm = jadm.ADMUNet(**kw)
    x, t, _ = _inputs()
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t),
                                seed=1)
    tm = tadm.ADMUNet(**kw, device="cpu")
    tm.load_state_dict(weights.from_jax_params(params))
    return jm, tm, params


@pytest.mark.parametrize("new_order", [False, True], ids=["legacy", "new"])
def test_unet_f32_forward_and_vjp(new_order):
    """float32 forward and the vjp w.r.t. x at a random cotangent. atol
    5e-5 on outputs of magnitude ~3: both sides are float32 with
    different conv and reduction orders (measured ~4e-6)."""
    jm, tm, params = _pair(new_order)
    x, t, ct = _inputs()
    f = jax.jit(lambda xx: jm.apply({"params": params}, xx, jnp.asarray(t)))
    y_j, vjp = jax.vjp(f, jnp.asarray(x))
    g_j = vjp(jnp.asarray(ct))[0]

    xt = nchw(x).requires_grad_(True)
    y_t = tm(xt, torch.tensor(t))
    g_t, = torch.autograd.grad(y_t, xt, grad_outputs=nchw(ct))
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), atol=5e-5)
    np.testing.assert_allclose(nhwc(g_t), np.asarray(g_j), atol=5e-5)


def test_unet_v2_f32_forward_and_vjp():
    """ADMUNetV2: (eps, logvar, logvar_ot) from the out_cov head on the
    penultimate feature map, and the vjp w.r.t. x of all three at random
    cotangents, float32, atol 5e-5 (as above)."""
    jm = jadm.ADMUNetV2(unet=jadm.ADMUNet(**SMALL_UNET))
    x, t, _ = _inputs()
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t),
                                seed=2)
    tm = tadm.ADMUNetV2(tadm.ADMUNet(**SMALL_UNET, device="cpu"))
    tm.load_state_dict(weights.from_jax_params(params))
    out_j, vjp = jax.vjp(jax.jit(lambda xx: jm.apply(
        {"params": params}, xx, jnp.asarray(t))), jnp.asarray(x))
    rng = np.random.RandomState(4)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in out_j]
    g_j = vjp(tuple(jnp.asarray(c) for c in cts))[0]
    xt = nchw(x).requires_grad_(True)
    out_t = tm(xt, torch.tensor(t))
    g_t, = torch.autograd.grad(out_t, xt, grad_outputs=[nchw(c) for c in cts])
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=5e-5)
    np.testing.assert_allclose(nhwc(g_t), np.asarray(g_j), atol=5e-5)
    # naming: the reference's V2 module names round-trip through kdip_tpu
    sd = tm.state_dict()
    cov = ckpt.convert_v2_out_cov(sd)
    np.testing.assert_array_equal(cov["kernel"], params["out_cov"]["kernel"])
    assert sorted(k for k in sd if not k.startswith("inner_model.")) == [
        "out_cov.bias", "out_cov.weight"]


def test_unet_bf16_torso_drift():
    """The bfloat16 torso (params pre-cast, GroupNorm float32) against
    kdip_tpu's bfloat16 torso, at the drift tolerance of
    test_mixed_precision.py::test_bf16_unet_close_to_f32: bf16 rounds at
    other places in the two frameworks (XLA fuses elementwise chains in
    f32; the decoder's split-skip form adds one rounding), so the two agree
    only as closely as each agrees with float32."""
    jm32, tm, params = _pair()
    x, t, _ = _inputs()
    jbf = jadm.ADMUNet(**SMALL_UNET, dtype=jnp.bfloat16)
    y_j = np.asarray(jax.jit(lambda xx: jbf.apply(
        {"params": precast_inference_params(params)}, xx,
        jnp.asarray(t)))(jnp.asarray(x)))
    weights.precast_inference(tm)
    assert tm.dtype == torch.bfloat16
    for m in tm.modules():
        if isinstance(m, GroupNorm32):
            assert m.weight.dtype == torch.float32
    y_t = nhwc(tm(nchw(x), torch.tensor(t)))
    scale = float(np.abs(y_j).max())
    assert float(np.abs(y_t - y_j).max()) <= 0.1 * max(scale, 1.0)


def test_state_dict_names_round_trip():
    """kdip_tpu's converter maps the port's state dict back onto the exact
    flax tree: the port carries guided-diffusion's module names."""
    _, tm, params = _pair()
    back = ckpt.convert_adm_state_dict(tm.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(want)
    for path, v in want:
        np.testing.assert_array_equal(flat[path], v)
