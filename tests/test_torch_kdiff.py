"""The port's k-diffusion native UNets (`kdip_tpu_torch.models.kdiff`)
against `kdip_tpu.models.kdiff`, on the CPU in float32: ImageDenoiserModelV2
and V1 with and without their variance outputs, the FIR resampling,
CrossAttention2d, `karras_augment_wrapper`, and the k-diffusion state-dict
names through `kdip_tpu.ckpt.convert_kdiff_state_dict` and
`weights.kdiff_from_jax_params`. The port's seeded random weights are
carried into JAX by `kdip_tpu`'s own converter; flax runs eagerly (no
compile)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu import ckpt as jckpt
from kdip_tpu.models import kdiff as jk
from kdip_tpu_torch import ckpt as tckpt
from kdip_tpu_torch import weights
from kdip_tpu_torch.models import kdiff as tk
from test_torch_port import nchw, nhwc, random_flax_params

S = 32
# three levels, channels <= 64, attention on the middle level only
BASE = dict(c_in=3, feats_in=32, depths=(1, 2, 1), channels=(32, 64, 64),
            self_attn_depths=(False, True, False))
CASES = {
    "v2-variance": (tk.ImageDenoiserModelV2, jk.ImageDenoiserModelV2,
                    dict(has_variance=True)),
    "v2": (tk.ImageDenoiserModelV2, jk.ImageDenoiserModelV2, {}),
    "v2-patch2-skip1-conds": (
        tk.ImageDenoiserModelV2, jk.ImageDenoiserModelV2,
        dict(has_variance=True, patch_size=2, skip_stages=1,
             mapping_cond_dim=5, unet_cond_dim=2)),
    "v1-variance": (tk.ImageDenoiserModelV1, jk.ImageDenoiserModelV1,
                    dict(has_variance=True)),
    "v1": (tk.ImageDenoiserModelV1, jk.ImageDenoiserModelV1, {}),
    "v1-patch2-skip1-conds": (
        tk.ImageDenoiserModelV1, jk.ImageDenoiserModelV1,
        dict(has_variance=True, patch_size=2, skip_stages=1,
             mapping_cond_dim=5, unet_cond_dim=2)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's small CPU ops on one thread (see test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(model: torch.nn.Module, seed: int, std: float = 0.05):
    """Every parameter std*N(0,1) from a seeded numpy generator (proj_out,
    zero at init, included); buffers (FIR kernels, Fourier weights) kept."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.copy_(torch.from_numpy(
                std * rng.standard_normal(p.shape, dtype=np.float32)))
    return model


def pair(case: str, seed: int = 0):
    """(port model, kdip_tpu module, its params, the flax kwargs)."""
    TM, JM, extra = CASES[case]
    kw = dict(BASE, **extra)
    torch.manual_seed(seed)
    tm = randomize(TM(**kw, device="cpu"), seed)
    params = jckpt.convert_kdiff_state_dict(tm.state_dict(),
                                            num_levels=len(kw["depths"]))
    return tm, JM(**kw), params, kw


def inputs(kw, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, S, 3), dtype=np.float32)
    sigma = np.array([0.3, 5.0], np.float32)
    mc = (rng.standard_normal((2, kw.get("mapping_cond_dim", 0)),
                              dtype=np.float32)
          if kw.get("mapping_cond_dim") else None)
    uc = (rng.standard_normal((2, S, S, kw["unet_cond_dim"]),
                              dtype=np.float32)
          if kw.get("unet_cond_dim") else None)
    return x, sigma, mc, uc


def close(got, want, rtol=1e-5):
    """Elementwise within rtol, and within rtol of the largest |want|: both
    sides float32, with other conv and reduction orders (measured <= 9e-6
    of the largest value)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_kdip_tpu(case):
    """The forward with return_variance (V2: out, logvar, logvar_ot; V1:
    out and the scalar logvar) and without, at 32 px: patch_size 2 runs
    the pixel (un)shuffle order, skip_stages 1 the skipped level, the
    mapping and unet conditioning their inputs."""
    tm, jm, params, kw = pair(case)
    x, sigma, mc, uc = inputs(kw)
    jkw = dict(mapping_cond=None if mc is None else jnp.asarray(mc),
               unet_cond=None if uc is None else jnp.asarray(uc))
    tkw = dict(mapping_cond=None if mc is None else torch.from_numpy(mc),
               unet_cond=None if uc is None else nchw(uc))
    for rv in (True, False):
        want = jm.apply({"params": params}, jnp.asarray(x),
                        jnp.asarray(sigma), return_variance=rv, **jkw)
        with torch.no_grad():
            got = tm(nchw(x), torch.from_numpy(sigma), return_variance=rv,
                     **tkw)
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        assert len(got) == len(want) == (
            1 + (rv and kw.get("has_variance", False))
            * (2 if "v2" in case else 1))
        for g, w in zip(got, want):
            close(nhwc(g) if g.ndim == 4 else g.numpy(), w)


@pytest.mark.parametrize("which", ["down", "up"])
def test_fir_resample_matches(which):
    """Downsample2d / Upsample2d alone (reflect pad, the linear FIR kernel,
    stride-2 conv and transposed conv), 6 channels at 8 x 10 px; the
    kernel a persistent buffer of k-diffusion's [4, 4]."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 10, 6), dtype=np.float32)
    tm = tk.Downsample2d() if which == "down" else tk.Upsample2d()
    jm = jk.Downsample2d() if which == "down" else jk.Upsample2d()
    want = np.asarray(jm.apply({}, jnp.asarray(x)))
    got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape == (
        (2, 4, 5, 6) if which == "down" else (2, 16, 20, 6))
    close(got, want)
    k = np.array(tk.FIR_KERNELS["linear"], np.float32) * (
        2 if which == "up" else 1)
    assert list(tm.state_dict()) == ["kernel"]
    np.testing.assert_array_equal(tm.kernel.numpy(), np.outer(k, k))


def test_cross_attention_matches():
    """CrossAttention2d: AdaGN'd queries at 8 x 8 px, 64 channels in 4
    heads, over a LayerNorm'd 5-token sequence of width 24 whose last two
    tokens of the second sample are padding (the additive -1e4 mask)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 64), dtype=np.float32)
    cond = rng.standard_normal((2, 16), dtype=np.float32)
    cross = rng.standard_normal((2, 5, 24), dtype=np.float32)
    pad = np.zeros((2, 5), np.float32)
    pad[1, 3:] = 1
    tm = randomize(tk.CrossAttention2d(64, 24, 4, 2, 16), 4)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}

    def conv(name):
        return {"kernel": sd[f"{name}.weight"].transpose(2, 3, 1, 0),
                "bias": sd[f"{name}.bias"]}
    params = {
        "norm_dec": {"mapper": {"kernel": sd["norm_dec.mapper.weight"].T,
                                "bias": sd["norm_dec.mapper.bias"]}},
        "q_proj": conv("q_proj"), "out_proj": conv("out_proj"),
        "norm_enc": {"scale": sd["norm_enc.weight"],
                     "bias": sd["norm_enc.bias"]},
        "kv_proj": {"kernel": sd["kv_proj.weight"].T,
                    "bias": sd["kv_proj.bias"]}}
    jm = jk.CrossAttention2d(64, 24, 4, 2)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond),
                    jnp.asarray(cross), jnp.asarray(pad))
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(cond), torch.from_numpy(cross),
                 torch.from_numpy(pad))
    close(nhwc(got), want)
    # the mask acts: other padded tokens give the same output
    cross2 = cross.copy()
    cross2[1, 3:] += 5.0
    with torch.no_grad():
        got2 = tm(nchw(x), torch.from_numpy(cond), torch.from_numpy(cross2),
                  torch.from_numpy(pad))
    np.testing.assert_allclose(got2[1].numpy(), got[1].numpy(), atol=1e-6)


def test_karras_augment_wrapper_matches():
    """The wrapper feeds 9 zeros of aug_cond, or aug_cond then a given
    mapping_cond, into a model whose mapping_cond takes 9 + 5 values."""
    tm, jm, params, kw = pair("v2-patch2-skip1-conds")
    kw = dict(kw, mapping_cond_dim=14)
    torch.manual_seed(0)
    tm = randomize(tk.ImageDenoiserModelV2(**kw, device="cpu"), 5)
    params = jckpt.convert_kdiff_state_dict(tm.state_dict(), 3)
    jm = jk.ImageDenoiserModelV2(**kw)
    x, sigma, mc, uc = inputs(dict(kw, mapping_cond_dim=5))
    aug = np.random.default_rng(6).standard_normal((2, 9), dtype=np.float32)
    japply = jk.karras_augment_wrapper(
        lambda p, *a, **k: jm.apply({"params": p}, *a, **k))
    tapply = tk.karras_augment_wrapper(tm)
    for a in (None, aug):
        want = japply(params, jnp.asarray(x), jnp.asarray(sigma),
                      aug_cond=None if a is None else jnp.asarray(a),
                      mapping_cond=jnp.asarray(mc),
                      unet_cond=jnp.asarray(uc))
        with torch.no_grad():
            got = tapply(nchw(x), torch.from_numpy(sigma),
                         aug_cond=None if a is None else torch.from_numpy(a),
                         mapping_cond=torch.from_numpy(mc), unet_cond=nchw(uc))
        close(nhwc(got), want)


@pytest.mark.parametrize("case", ["v2-variance", "v2-patch2-skip1-conds"])
def test_state_dict_names_load_strictly_and_round_trip(case):
    """The port's state dict has k-diffusion's names (mapping.{0,2},
    u_net.d_blocks / u_blocks, main.{0,2,4,6}, the FIR kernel buffers),
    loads strictly into a fresh model through ckpt.load_strict, and
    round-trips through kdip_tpu's converter and kdiff_from_jax_params bit
    for bit; a misnamed key fails the load."""
    tm, _, params, kw = pair(case)
    sd = tm.state_dict()
    n = len(kw["depths"])
    skip = kw.get("skip_stages", 0)
    j = 1 if 1 > skip else 0  # level 1's down block: its FIR first
    assert {"timestep_embed.weight", "mapping.0.weight", "mapping.2.weight",
            "proj_in.weight", "proj_out.bias",
            f"u_net.d_blocks.1.{j}.main.0.mapper.weight",
            f"u_net.d_blocks.1.{j}.main.6.weight",
            f"u_net.d_blocks.1.{j + 1}.qkv_proj.weight",
            "u_net.u_blocks.1.0.skip.weight"} <= set(sd)
    # the down block's FIR first, the up block's after its layers
    layers = [d * (2 if a else 1) for d, a in
              zip(BASE["depths"], BASE["self_attn_depths"])]
    assert sorted(k for k in sd if k.endswith(".kernel")) == sorted(
        [f"u_net.d_blocks.{i}.0.kernel" for i in range(skip + 1, n)]
        + [f"u_net.u_blocks.{n - 1 - i}.{layers[i]}.kernel"
           for i in range(skip + 1, n)])
    torch.manual_seed(1)
    fresh = tckpt.load_strict(type(tm)(**kw, device="cpu"), sd)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in sd.items())
    back = weights.kdiff_from_jax_params(params, n, skip_stages=skip)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    bad = dict(sd)
    bad["mapping.0.wieght"] = bad.pop("mapping.0.weight")
    with pytest.raises(RuntimeError, match="mapping.0.w"):
        tckpt.load_strict(type(tm)(**kw, device="cpu"), bad)


def test_jax_init_tree_converts():
    """A tree of flax's own init (skip_stages 1: no level-0 blocks) maps to
    the port's names; the model loads it with only the skipped level's
    blocks missing, and computes kdip_tpu's output."""
    kw = dict(BASE, has_variance=True, skip_stages=1)
    jm = jk.ImageDenoiserModelV2(**kw)
    x, sigma, _, _ = inputs(kw)
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(sigma),
                                seed=7)
    sd = weights.kdiff_from_jax_params(params, 3)
    tm = tk.ImageDenoiserModelV2(**kw, device="cpu")
    res = tm.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys and res.missing_keys
    assert all(k.startswith(("u_net.d_blocks.0.", "u_net.u_blocks.2."))
               for k in res.missing_keys)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(sigma),
                    return_variance=True)
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(sigma), return_variance=True)
    for g, w in zip(got, want):
        close(nhwc(g), w)
