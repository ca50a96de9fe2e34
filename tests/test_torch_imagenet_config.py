"""The ImageNet-256 config (configs/test_imagenet.json: 256 channels, 2 res
blocks, attention at 8, 16 and 32 px) through the port's
`config.make_openai_model`, against `kdip_tpu`'s: at reduced width its
float32 output and x-vjp on the same seeded weights, and at full width,
on the meta device and through `jax.eval_shape` (no arithmetic), every
parameter's name and shape."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import ckpt as jckpt
from kdip_tpu import config as jconfig
from kdip_tpu.models import adm as jadm
from test_torch_adm_rest import close
from test_torch_port import REPO, nchw, nhwc, random_flax_params

CONFIG = os.path.join(REPO, "configs", "test_imagenet.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's small CPU ops on one thread (see test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(**openai):
    """The config's "model" block as both packages merge it, its "openai"
    flags updated by `openai`."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["model"]["openai"].update(openai)
    tc, jc = P.config.load_config(cfg), jconfig.load_config(cfg)
    assert tc == jc
    return tc["model"]


def test_reduced_width_matches_kdip_tpu():
    """32 channels at 64 px, the config's channel multipliers
    (1,1,2,2,4,4) and attention at the same levels (downsample rates 8,
    16 and 32, written "8,4,2" at 64 px), 2 res blocks: the forward
    within 1e-5 of the largest value and its vjp w.r.t. x within 3e-5,
    float32 on both sides (measured 2.4e-6 and 1.0e-5: the vjp carries
    the summation-order differences back through all 28 ResBlocks)."""
    mc = load(num_channels=32, image_size=64, channel_mult="1,1,2,2,4,4",
              attention_resolutions="8,4,2")
    jm, jt = jconfig.make_openai_model(mc)
    assert jm.attention_resolutions == (8, 16, 32)
    tm, tt = P.config.make_openai_model(mc, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 64, 3), dtype=np.float32)
    t = np.array([321.5], np.float32)
    ct = rng.standard_normal((1, 64, 64, 6), dtype=np.float32)
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t),
                                seed=2)
    tm.load_state_dict(P.weights.from_jax_params(params))
    # the config's dropout 0.1 is live under train(); jm.apply is
    # deterministic
    tm.eval()
    f = jax.jit(lambda a: jm.apply({"params": params}, a, jnp.asarray(t)))
    y_j, vjp = jax.vjp(f, jnp.asarray(x))
    g_j = vjp(jnp.asarray(ct))[0]
    xt = nchw(x).requires_grad_(True)
    y_t = tm(xt, torch.from_numpy(t))
    g_t, = torch.autograd.grad(y_t, xt, grad_outputs=nchw(ct))
    close(nhwc(y_t), y_j)
    close(nhwc(g_t), g_j, rtol=3e-5)
    np.testing.assert_array_equal(tt.betas.numpy(), np.asarray(jt.betas))


def same_shapes(tm, jm, *labels):
    """Holds the port's model `tm` (on the meta device) against kdip_tpu's
    `jm` initialised under jax.eval_shape at 256 px, tensor by tensor, each
    port name mapped by kdip_tpu's own converter (convert_adm_state_dict)
    to its flax path and layout. `labels` is the init's label argument of
    a class-conditional model. Returns the parameter count."""
    shapes = jax.eval_shape(
        jm.init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.float32), *labels)["params"]
    flat = {tuple(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    sd = tm.state_dict()
    seen = set()
    for name, t in sd.items():
        # one tensor at a time, so no more than one is ever in memory
        tree = jckpt.convert_adm_state_dict(
            {name: np.zeros(t.shape, np.float32)})
        (path, leaf), = jax.tree_util.tree_flatten_with_path(tree)[0]
        key = tuple(k.key for k in path)
        assert flat[key] == leaf.shape, (name, key)
        seen.add(key)
    assert seen == set(flat)
    n = sum(t.numel() for t in sd.values())
    assert n == sum(int(np.prod(s)) for s in flat.values())
    return n


def test_full_width_shapes_match_kdip_tpu():
    """The config as it is (256 px, 256 channels): the port's model on the
    meta device and kdip_tpu's init under jax.eval_shape hold the same
    552,814,086 parameters, tensor by tensor (same_shapes); and the model
    has 42 ResBlocks, 5 of them down."""
    mc = load()
    tm, _ = P.config.make_openai_model(mc, device="meta")
    jm, _ = jconfig.make_openai_model(mc)
    assert same_shapes(tm, jm) == 552_814_086
    blocks = [m for m in tm.modules() if isinstance(m, P.layers.ResBlock)]
    assert len(blocks) == 42 and sum(b.down for b in blocks) == 5


def test_imagenet_unet_matches_kdip_tpu():
    """`models.adm.imagenet_unet`, which writes the config's widths a
    second time, class-conditional: tensor by tensor the shapes of
    kdip_tpu's `imagenet_unet(class_cond=True)` (same_shapes), the
    config's 552,814,086 parameters and a [1000, 1024] label embedding;
    and its state dict, name by name and shape by shape, is that of the
    config's model (make_openai_model) with class_cond."""
    tm = P.adm.imagenet_unet(class_cond=True, device="meta")
    n = same_shapes(tm, jadm.imagenet_unet(class_cond=True),
                    jax.ShapeDtypeStruct((1,), jnp.int32))
    assert tm.label_emb.weight.shape == (1000, 1024)
    assert n == 552_814_086 + 1000 * 1024
    cm, _ = P.config.make_openai_model(load(class_cond=True), device="meta")
    assert ({k: v.shape for k, v in tm.state_dict().items()}
            == {k: v.shape for k, v in cm.state_dict().items()})
