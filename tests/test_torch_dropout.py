"""Live dropout in the port's UNets (`models.layers.Dropout` in the ADM
ResBlock, `models.kdiff`'s ResConvBlock and attention), on the CPU.

At dropout 0 under train() the port equals `kdip_tpu`'s forward with
deterministic=False (flax's Dropout at rate 0 is the identity); under
eval() a model with dropout equals the one without, bit for bit. A live
mask is drawn from the generator set by `set_dropout_generator`, so it is
injected by seeding: the ResBlock's output is recomputed from its own
pre-dropout activation and a mask drawn from a generator seeded alike.
How often a mask keeps a value is checked statistically (the only claim
about a random mask that does not depend on the generator's stream). With
live dropout the bf16 Winograd ResBlocks take the unfused path: counted
through a counting `ops.winograd._run` stand-in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu.models import adm as jadm
from kdip_tpu_torch.models.layers import Dropout, ResBlock
from test_torch_kdiff import inputs as kdiff_inputs
from test_torch_kdiff import pair as kdiff_pair
from test_torch_port import (SMALL_UNET, nchw, nhwc,  # noqa: F401
                             one_torch_thread, random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = SMALL_UNET["image_size"]


def _adm_pair(dropout, winograd=False, seed=2):
    jm = jadm.ADMUNet(**SMALL_UNET, dropout=dropout)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=seed)
    tm = P.adm.ADMUNet(**SMALL_UNET, dropout=dropout, device="cpu",
                       winograd=winograd)
    tm.load_state_dict(P.weights.from_jax_params(params))
    return jm, params, tm


def _x(seed=3, b=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, S, S, 3)).astype(np.float32),
            np.array([5.0, 700.0][:b], np.float32))


def test_adm_dropout_zero_train_matches_kdip_tpu():
    """train() at dropout 0 against flax with deterministic=False, float32,
    within 1e-5 of the largest value (the port's inference parity bound)."""
    jm, params, tm = _adm_pair(0.0)
    x, t = _x()
    want = np.asarray(jax.jit(lambda xx: jm.apply(
        {"params": params}, xx, jnp.asarray(t), deterministic=False))(
            jnp.asarray(x)))
    tm.train()
    got = nhwc(tm(nchw(x), torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_kdiff_dropout_zero_train_matches_kdip_tpu():
    """The k-diffusion V2 UNet with variance, train() at dropout_rate 0,
    against flax with deterministic=False: within 1e-5 of the largest
    value (test_torch_kdiff's bound)."""
    tm, jm, params, kw = kdiff_pair("v2-variance")
    x, sigma, _, _ = kdiff_inputs(kw)
    tm.train()
    want = jax.jit(lambda xx: jm.apply(
        {"params": params}, xx, jnp.asarray(sigma), return_variance=True,
        deterministic=False))(jnp.asarray(x))
    got = tm(nchw(x), torch.from_numpy(sigma), return_variance=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_eval_is_the_identity():
    """Under eval() a model with dropout 0.5 (ADM and k-diffusion V2, every
    site) equals the same weights at dropout 0, bit for bit; under train()
    it does not."""
    _, params, tm = _adm_pair(0.5)
    _, _, plain = _adm_pair(0.0)
    x, t = _x()
    tm.eval()
    with torch.no_grad():
        a = tm(nchw(x), torch.from_numpy(t))
        b = plain(nchw(x), torch.from_numpy(t))
        assert torch.equal(a, b)
        tm.train()
        assert not torch.equal(tm(nchw(x), torch.from_numpy(t)), b)
    kw = dict(c_in=3, feats_in=32, depths=(1, 1), channels=(32, 32),
              self_attn_depths=(False, True))
    torch.manual_seed(0)
    kd = P.kdiff.ImageDenoiserModelV2(**kw, dropout_rate=0.5, device="cpu")
    torch.manual_seed(0)
    k0 = P.kdiff.ImageDenoiserModelV2(**kw, device="cpu")
    k0.load_state_dict(kd.state_dict())
    sites = [m for m in kd.modules() if isinstance(m, Dropout)]
    assert len(sites) == 2 * 4 + 2 and all(m.p == 0.5 for m in sites)
    for m in (kd, k0):
        torch.nn.init.normal_(m.proj_out.weight, generator=torch.Generator(
        ).manual_seed(1))
    xs = torch.rand(2, 3, 16, 16) * 2 - 1
    sig = torch.tensor([0.5, 3.0])
    kd.eval()
    with torch.no_grad():
        assert torch.equal(kd(xs, sig), k0(xs, sig))
        kd.train()
        assert not torch.equal(kd(xs, sig), k0(xs, sig))


def test_injected_mask_in_resblock():
    """A float32 ResBlock at dropout 0.3 under train(), its masks drawn
    from a seeded generator: the output is the eval-mode block's arithmetic
    with h_drop = where(mask, h / 0.7, 0), the mask drawn from a generator
    seeded alike, h the activation entering out_layers[2] (caught by a
    hook). The same seed gives the same output; another seed another."""
    torch.manual_seed(0)
    blk = ResBlock(32, 64, torch.float32, out_channels=32, dropout=0.3)
    x = torch.randn(2, 32, 8, 8)
    emb = torch.randn(2, 64)
    seen = {}
    drop = blk.out_layers[2]
    hook = drop.register_forward_hook(
        lambda m, inp, out: seen.update(h=inp[0], out=out))
    P.layers.set_dropout_generator(blk, torch.Generator().manual_seed(11))
    y = blk(x, emb)
    hook.remove()
    keep = torch.rand(seen["h"].shape,
                      generator=torch.Generator().manual_seed(11)) < 0.7
    want = torch.where(keep, seen["h"] / 0.7, torch.zeros_like(seen["h"]))
    assert torch.equal(seen["out"], want)
    assert 0 < int((~keep).sum()) < keep.numel()
    # the rest of the block is eval()'s arithmetic on that h_drop
    out_conv = blk.out_layers[3]
    assert torch.equal(y, blk.skip_connection(x) + out_conv(want))
    P.layers.set_dropout_generator(blk, torch.Generator().manual_seed(11))
    assert torch.equal(blk(x, emb), y)
    P.layers.set_dropout_generator(blk, torch.Generator().manual_seed(12))
    assert not torch.equal(blk(x, emb), y)


def test_dropout_keep_rate_statistical():
    """Why statistical: which values a mask keeps depends on the
    generator's stream, not on anything kdip_tpu fixes; what dropout
    promises is the keep rate 1 - p and the 1 / (1 - p) scale. Over 10^6
    values at p = 0.1 the dropped share is within 5 sigma (sqrt(p (1 - p)
    / n) = 3e-4) of p, every kept value is x / 0.9 in x's dtype (bf16
    here), and p = 0 or eval() returns x itself."""
    d = Dropout(0.1)
    d.generator = torch.Generator().manual_seed(5)
    x = (torch.rand(1000, 1000) + 0.5).to(torch.bfloat16)
    y = d(x)
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.1) <= 5 * (0.1 * 0.9 / x.numel()) ** 0.5
    kept = y != 0
    assert torch.equal(y[kept], (x / 0.9)[kept])
    assert y.dtype == torch.bfloat16
    d.eval()
    assert d(x) is x
    assert Dropout(0.0)(x) is x
    with pytest.raises(ValueError):
        Dropout(1.0)


@pytest.mark.parametrize("dropout,train,fused", [
    (0.1, True, False), (0.1, False, True), (0.0, True, True)])
def test_winograd_gate_follows_live_dropout(dropout, train, fused):
    """The bf16 Winograd torso fuses GroupNorm + SiLU into the kernel only
    where no dropout is live (kdip_tpu layers.py:311-313): under train()
    at 0.1 every eligible 3x3 conv of a ResBlock runs the plain entry
    point (2 a block), 0 fused; under eval(), or at dropout 0, the NFE's
    split (plain in each down-block's in_conv, fused elsewhere). The
    backward's dx is the plain entry point once a conv either way."""
    _, _, tm = _adm_pair(dropout, winograd=True)
    P.weights.precast_inference(tm)
    tm.train(train)
    blocks = [m for m in tm.modules() if isinstance(m, ResBlock)]
    down = sum(b.down for b in blocks)
    counts = {"plain": 0, "fused": 0}
    run = P.ops.winograd._run

    def counting(x, v, prologue=None):
        counts["plain" if prologue is None else "fused"] += 1
        return run(x, v, prologue)
    x, t = _x(b=1)
    P.ops.winograd._run = counting
    try:
        y = tm(nchw(x), torch.from_numpy(t))
        fwd = dict(counts)
        y.float().square().sum().backward()
    finally:
        P.ops.winograd._run = run
    if fused:
        assert fwd == {"plain": down, "fused": 2 * len(blocks) - down}
    else:
        assert fwd == {"plain": 2 * len(blocks), "fused": 0}
    assert counts["plain"] - fwd["plain"] == 2 * len(blocks)
    assert counts["fused"] == fwd["fused"]
