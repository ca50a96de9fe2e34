"""ops.tiling of the port against `kdip_tpu.ops.tiling`, NCHW against NHWC:
every mode of `tiled_inference` around a stub `apply` (a seeded 3x3 conv,
zero-padded, and the same conv followed by a 2x nearest upsample for
sf=2) and around the SMALL_UNET ADM UNet; the dihedral augments and the
edge padding alone; and the Winograd torso's calls at a tile size whose
deeper level is odd, as chip_smoke's aux_modules phase counts them.

Tolerances: the tiling itself only slices, pads, rotates and stitches, so
it adds no rounding; the stub conv is float32 in both packages (XLA's and
torch's sums of 27 terms in other orders): 1e-5. The x8 ensemble averages
8 such outputs: 1e-5. The UNet: 1e-5, as tests/test_torch_cli.py holds
its forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import kdip_tpu_torch as P
from kdip_tpu.models import adm as jadm
from kdip_tpu.ops import tiling as jt
from kdip_tpu_torch.ops import tiling as tt
from kdip_tpu_torch.ops import winograd as Wg
from test_torch_port import (SMALL_UNET, nchw, nhwc, one_torch_thread,  # noqa: F401
                             random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = (np.random.RandomState(0).standard_normal((3, 3, 3, 4)) * 0.3
     ).astype(np.float32)                        # HWIO
KT = torch.from_numpy(np.ascontiguousarray(K.transpose(3, 2, 0, 1)))


def j_apply(sf):
    def f(x):
        y = jax.lax.conv_general_dilated(
            x, jnp.asarray(K), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.repeat(jnp.repeat(y, sf, 1), sf, 2) if sf > 1 else y
    return f


def t_apply(sf):
    def f(x):
        y = F.conv2d(x, KT, padding=1)
        return (y.repeat_interleave(sf, -2).repeat_interleave(sf, -1)
                if sf > 1 else y)
    return f


def _x(h, w, seed=1):
    return np.random.RandomState(seed).standard_normal(
        (2, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("mode,sf,hw", [
    (0, 1, (14, 18)), (1, 1, (14, 18)), (1, 2, (13, 10)),
    (2, 1, (20, 22)), (2, 2, (20, 22)), (2, 1, (12, 14)),
    (3, 1, (14, 18)), (4, 1, (20, 22)), (5, 1, (12, 14)), (5, 2, (20, 22))],
    ids=str)
def test_tiled_inference_matches(mode, sf, hw):
    """Each mode at refield 4, min_size 8, modulo 4 (mode 2 at 20 x 22
    splits twice: tiles of 12, then of 8); the output within 1e-5 and of
    the whole image's size times sf."""
    x = _x(*hw)
    kw = dict(refield=4, min_size=8, sf=sf, modulo=4)
    want = np.asarray(jt.tiled_inference(j_apply(sf), jnp.asarray(x), mode,
                                         **kw))
    got = tt.tiled_inference(t_apply(sf), nchw(x), mode, **kw)
    assert got.shape == (2, 4, hw[0] * sf, hw[1] * sf)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


def test_augment_and_padding_match():
    """The 8 dihedral transforms of a non-square image, and the edge
    padding to a modulo: bit-equal."""
    x = _x(5, 7)
    for mode in range(8):
        np.testing.assert_array_equal(
            nhwc(tt.augment_img(nchw(x), mode)),
            np.asarray(jt.augment_img(jnp.asarray(x), mode)))
    for modulo in (1, 4, 16):
        np.testing.assert_array_equal(
            nhwc(tt.replication_pad_to_modulo(nchw(x), modulo)),
            np.asarray(jt.replication_pad_to_modulo(jnp.asarray(x), modulo)))
    with pytest.raises(ValueError):
        tt.tiled_inference(t_apply(1), nchw(x), 6)


def test_split_stitches_each_tiles_inner_quadrant():
    """Mode 5 on a position-dependent apply: each output quadrant is its
    tile's own output there, bit for bit, the tiles reaching past the
    middle by the receptive field."""
    x = torch.from_numpy(_x(24, 20)).permute(0, 3, 1, 2)

    def apply(t):  # depends on where the tile starts: its first value
        return t + t[..., :1, :1]
    out = tt.tiled_inference(apply, x, 5, refield=8)
    (rt, ct), (_, cr), (rb, _), _ = tt.split_tiles(24, 20, 8)
    assert (rt.stop, ct.stop, cr.start, rb.start) == (16, 16, 4, 8)
    tiles = [apply(x[..., r, c]) for r, c in tt.split_tiles(24, 20, 8)]
    assert torch.equal(out[..., :12, :10], tiles[0][..., :12, :10])
    assert torch.equal(out[..., :12, 10:], tiles[1][..., :12, -10:])
    assert torch.equal(out[..., 12:, :10], tiles[2][..., -12:, :10])
    assert torch.equal(out[..., 12:, 10:], tiles[3][..., -12:, -10:])


def test_unet_modes_match():
    """SMALL_UNET (two levels) as `apply`, at t = 500: mode 1 (14 px padded
    to 16), mode 3 (the x8 ensemble at 16 px) and mode 5 (24 px in four
    16 px tiles at refield 8), port against kdip_tpu."""
    S = SMALL_UNET["image_size"]
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=31)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    jf = jax.jit(lambda x: jm.apply({"params": params}, x,
                                    jnp.full((x.shape[0],), 500.0)))

    def tf(x):
        with torch.no_grad():
            return tm(x, torch.full((x.shape[0],), 500.0))
    x = np.random.RandomState(32).uniform(-1, 1, (1, 24, 24, 3)).astype(
        np.float32)
    for mode, inp, kw in ((1, x[:, :14, :14], dict(modulo=4)),
                          (3, x[:, :16, :16], {}),
                          (5, x, dict(refield=8))):
        want = np.asarray(jt.tiled_inference(jf, jnp.asarray(inp), mode,
                                             **kw))
        got = tt.tiled_inference(tf, nchw(inp), mode, **kw)
        assert got.shape[-2:] == inp.shape[1:3]
        np.testing.assert_allclose(nhwc(got), want, atol=1e-5,
                                   err_msg=f"mode {mode}")


def test_odd_level_takes_the_direct_conv(monkeypatch):
    """A bf16 Winograd torso (three levels) on 36 px tiles of a 64 px image
    (mode 5, refield 4): its levels are 36, 18 and 9 px, and the 9 px
    level's convs, H and W odd, take the direct conv. The Winograd
    calls equal what chip_smoke.winograd_call_log reads from the convs'
    inputs as they run, and fewer per forward than at 32 px."""
    calls = {k: 0 for k in Wg.launch_counts}
    plain = Wg._run

    def counting(x, v, prologue=None):
        calls["winograd_conv3x3" if prologue is None
              else "winograd_conv3x3_fused"] += 1
        return plain(x, v, prologue)
    monkeypatch.setattr(Wg, "_run", counting)
    model, _ = P.config.make_openai_model({"openai": {
        "num_channels": 32, "image_size": 32, "channel_mult": "1,2,2",
        "attention_resolutions": "8"}}, winograd=True, device="cpu")
    P.weights.randomize_(model, 33)
    P.weights.precast_inference(model).eval()

    def apply(t):
        with torch.no_grad():
            return model(t, torch.full((t.shape[0],), 300.0))
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(34))
    per = {}
    for name, inp, mode, kw in (("32px", x[..., :32, :32], 0, {}),
                                ("tiles", x, 5, dict(refield=4))):
        for k in calls:
            calls[k] = 0
        with chip_smoke.winograd_call_log(model) as log:
            out = tt.tiled_inference(apply, inp, mode, **kw)
        assert torch.isfinite(out).all()
        assert calls == {k: log[k] for k in calls}, (name, calls, log)
        per[name] = (sum(calls.values()), log["direct"], log["direct_px"])
    assert per["32px"][1] == 0
    assert per["tiles"][1] > 0 and per["tiles"][2] == [9]
    assert per["tiles"][0] < 4 * per["32px"][0]
