"""The last of `kdip_tpu`'s surface in the port: `sampling_api.
posterior_sample`, the composite Winograd conv over channel parts and its
`impl` dispatcher (`ops.winograd.winograd_conv3x3_parts`, kdip_tpu's
`winograd_conv3x3_jnp` / `winograd_conv3x3`), the `utils` leftovers, and
the five torch file kinds that kdip_tpu's `cli/convert_weights.py`
converts, which the port reads as they are.

Tolerances: posterior_sample as tests/test_torch_sampling.py (float32 on
both sides, differences of summation order carried through the guided
NFEs; sigma_max 2): 2e-3. The composite conv in float32: 1e-5 (sums of
9 C terms in other orders); in bf16 against the plain kernel version of
the concatenated input, Winograd's own bf16 bound of chip_smoke (2^-7 of
each value plus 2^-14 of the largest: the parts' float32 products summed
in another order, rounded once). The utils, the file loads and the
converted weights: bit-equal.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import ckpt as jckpt
from kdip_tpu import diffusion as jd
from kdip_tpu import guidance as jg
from kdip_tpu import operators as jo
from kdip_tpu import sampling_api as jsa
from kdip_tpu import utils as ju
from kdip_tpu.cli import convert_weights as jconvert
from kdip_tpu.models import adm as jadm
from kdip_tpu.models import inception as jinc
from kdip_tpu.ops.experimental import winograd as jw
from kdip_tpu_torch import ckpt as tckpt
from kdip_tpu_torch import metrics as tmetrics
from kdip_tpu_torch import utils as tu
from kdip_tpu_torch.cli import sample_condition as tcli
from kdip_tpu_torch.models import inception as tinc
from kdip_tpu_torch.ops import winograd as Wg
from test_torch_port import (SMALL_UNET, nchw, nhwc, one_torch_thread,  # noqa: F401
                             random_flax_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = SMALL_UNET["image_size"]


# ---------------------------------------------------------------------------
# sampling_api.posterior_sample
# ---------------------------------------------------------------------------

def test_posterior_sample_matches():
    """V1 Convert on p=0.5 inpainting, 3 Heun steps without churn, sigma_max
    2, two samples: kdip_tpu's one-shot call from its key against the
    port's from the same initial draw; and the port's call from a
    generator twice with one seed, bit-equal."""
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=41)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    op_cfg = dict(name="inpainting", sigma_s=0.05,
                  mask_opt=dict(mask_type="random",
                                mask_prob_range=(0.5, 0.5), image_size=S))
    jop = jo.get_operator(seed=1, **op_cfg)
    top = P.operators.get_operator(seed=1, device="cpu", **op_cfg)
    rng = np.random.RandomState(42)
    y = (rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
         * np.asarray(jop.mask))
    scfg = dict(steps=3, sigma_max=2.0, ode=True)
    key = jax.random.key(43)
    want = jsa.posterior_sample(
        lambda p, x, t: jm.apply({"params": p}, x,
                                 jnp.asarray(t, jnp.float32)),
        jd.make_diffusion(1000, "linear"), jop, jo.Measurement(
            y=jnp.asarray(y)), params, key,
        jg.GuidanceConfig("I", "convert"), jsa.SamplerConfig(**scfg),
        image_size=S)
    init = jax.random.normal(jax.random.split(key)[0], (1, S, S, 3))
    args = (tm, P.diffusion.make_diffusion(1000, "linear", device="cpu"),
            top, P.operators.Measurement(y=nchw(y)))
    kw = dict(guidance_cfg=P.guidance.GuidanceConfig("I", "convert"),
              sampler_cfg=P.sampling_api.SamplerConfig(**scfg),
              image_size=S, device="cpu")
    got = P.sampling_api.posterior_sample(*args, init_noise=nchw(init), **kw)
    assert got.shape == (1, 3, S, S) and torch.isfinite(got).all()
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-3)
    a, b = (P.sampling_api.posterior_sample(
        *args, generator=torch.Generator().manual_seed(7), n=2, **kw)
        for _ in range(2))
    assert a.shape == (2, 3, S, S) and torch.equal(a, b)


# ---------------------------------------------------------------------------
# ops.winograd.winograd_conv3x3_parts
# ---------------------------------------------------------------------------

def _wino_inputs(seed, B=2, C=(10, 14), F=7, H=8, W=12):
    rng = np.random.RandomState(seed)
    parts = [rng.standard_normal((B, H, W, c)).astype(np.float32) for c in C]
    k = (rng.standard_normal((3, 3, sum(C), F)) / np.sqrt(9 * sum(C))
         ).astype(np.float32)
    bias = rng.standard_normal(F).astype(np.float32)
    a = (1 + 0.3 * rng.standard_normal((B, sum(C)))).astype(np.float32)
    b = (0.3 * rng.standard_normal((B, sum(C)))).astype(np.float32)
    return parts, k, bias, a, b


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("prologue", [False, True])
def test_winograd_parts_match_kdip_tpu(prologue):
    """Two channel parts summed in transform space, with a bias, float32:
    the port's impl "plain" against kdip_tpu's winograd_conv3x3_jnp (and,
    with the prologue, its dispatcher's jnp path) and against F.conv2d of
    the concatenation."""
    parts, k, bias, a, b = _wino_inputs(44)
    pro_j = (jnp.asarray(a), jnp.asarray(b)) if prologue else None
    want = np.asarray(jw.winograd_conv3x3(
        tuple(jnp.asarray(p) for p in parts), jnp.asarray(k),
        jnp.asarray(bias), impl="jnp", prologue=pro_j))
    pro_t = (torch.from_numpy(a), torch.from_numpy(b)) if prologue else None
    got = Wg.winograd_conv3x3_parts(tuple(nchw(p) for p in parts), _oihw(k),
                                    torch.from_numpy(bias), impl="plain",
                                    prologue=pro_t)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    x = torch.cat([nchw(p) for p in parts], 1)
    if prologue:
        x = Wg.affine_silu(x, *pro_t)
    direct = torch.nn.functional.conv2d(x, _oihw(k), torch.from_numpy(bias),
                                        padding=1)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)


def test_winograd_parts_bf16_and_impls():
    """bf16: the parts' sum equals the plain kernel version of the
    concatenated input bit for bit, as does a single tensor. impl "cuda"
    on a CPU tensor raises (no silent switch to the plain version), as
    does an unknown impl."""
    parts, k, _, _, _ = _wino_inputs(45)
    tp = tuple(nchw(p).to(torch.bfloat16) for p in parts)
    w = _oihw(k).to(torch.bfloat16)
    got = Wg.winograd_conv3x3_parts(tp, w, impl="plain").float()
    x = torch.cat(tp, 1)
    want = Wg.winograd_conv3x3_plain(x, Wg.kernel_transform(w)).float()
    assert torch.equal(got, want)
    assert torch.equal(Wg.winograd_conv3x3_parts(x, w, impl="plain"),
                       Wg.winograd_conv3x3_plain(x, Wg.kernel_transform(w)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        Wg.winograd_conv3x3_parts(tp, w, impl="cuda")
    for bad in ("jnp", "pallas", None):
        with pytest.raises(ValueError, match="impl must be one of"):
            Wg.winograd_conv3x3_parts(tp, w, impl=bad)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_param_helpers_match():
    """n_params of the SMALL_UNET module and of its state dict equal
    kdip_tpu's of the flax params; cast_params and master_param_update on
    a state dict give kdip_tpu's leaves bit for bit (the integer entry
    kept as it is)."""
    jm = jadm.ADMUNet(**SMALL_UNET)
    params = random_flax_params(jm.init, jnp.zeros((1, S, S, 3)),
                                jnp.zeros((1,)), seed=46)
    tm = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
    sd = P.weights.from_jax_params(params)
    tm.load_state_dict(sd)
    assert tu.n_params(tm) == tu.n_params(sd) == ju.n_params(params)
    tree = {"w": np.linspace(-1, 1, 7, dtype=np.float32),
            "n": np.arange(3, dtype=np.int32)}
    upd = {"w": np.full(7, 1e-3, np.float32), "n": np.zeros(3, np.int32)}
    tsd = {k: torch.from_numpy(v) for k, v in tree.items()}
    cast = tu.cast_params(tsd, torch.bfloat16)
    jcast = ju.cast_params({k: jnp.asarray(v) for k, v in tree.items()},
                           jnp.bfloat16)
    assert cast["n"].dtype == torch.int32 and cast["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(cast["w"].float().numpy(),
                                  np.asarray(jcast["w"], np.float32))
    upd_t = {k: torch.from_numpy(v) for k, v in upd.items()}
    got = tu.master_param_update(cast, upd_t)
    want = ju.master_param_update(jcast, {k: jnp.asarray(v)
                                          for k, v in upd.items()})
    for k in tree:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert set(tu.cast_params(tm, torch.float16)) == set(sd)


def test_download_file_checks_its_digest(tmp_path):
    """A file:// URL (no network): fetched once, its SHA-256 checked, a
    wrong digest refused with OSError, an existing file not fetched
    again; as kdip_tpu's."""
    src = tmp_path / "src.bin"
    src.write_bytes(b"kdip" * 1000)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    url = src.as_uri()
    for mod in (tu, ju):
        dst = tmp_path / mod.__name__ / "d.bin"
        assert mod.download_file(dst, url, digest) == dst
        assert dst.read_bytes() == src.read_bytes()
        with pytest.raises(OSError, match="digest mismatch"):
            mod.download_file(dst, url, "0" * 64)
        dst.write_bytes(b"changed")
        mod.download_file(dst, url)  # present: not fetched again
        assert dst.read_bytes() == b"changed"


def test_pil_conversions_match():
    """from_pil_image (a PIL image or a uint8 array) and to_uint8 /
    to_pil_image against kdip_tpu's, which work in HWC: bit-equal."""
    from PIL import Image
    rng = np.random.RandomState(47)
    u8 = rng.randint(0, 256, (6, 5, 3), np.uint8)
    for img in (Image.fromarray(u8), u8, u8[..., 0]):
        got = tu.from_pil_image(img).numpy()
        want = ju.from_pil_image(img)
        np.testing.assert_array_equal(got, want.transpose(2, 0, 1))
    x = rng.uniform(-1.2, 1.2, (1, 3, 6, 5)).astype(np.float32)
    want = np.asarray(ju.to_pil_image(x.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(tu.to_uint8(torch.from_numpy(x)), want)
    np.testing.assert_array_equal(np.asarray(tu.to_pil_image(x[0])), want)
    np.testing.assert_array_equal(
        tu.to_uint8(x[0, :1]), np.asarray(ju.to_pil_image(x[0, 0])))


# ---------------------------------------------------------------------------
# The five kinds of kdip_tpu's convert_weights: read by the port as they are
# ---------------------------------------------------------------------------

def _random_sd(model: torch.nn.Module, seed: int):
    """The model's state dict with random floats, 0.05 N(0, 1) (a
    BatchNorm's running variance in [0.5, 1.5), so that a deep network's
    output stays finite), and its integer entries kept."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = 0.05 * torch.randn(v.shape, generator=g)
    return sd


@pytest.mark.parametrize("kind", ["adm", "v2", "lpips", "inception",
                                  "recon_mse"])
def test_convert_weights_kinds_read_as_they_are(kind, tmp_path):
    """For each kind that kdip_tpu's convert_weights.py:24 accepts, a torch
    file as its source has it (random values): the port loads the file
    itself, and its weights equal, bit for bit, what kdip_tpu's conversion
    of the same file gives once mapped back to torch names (for lpips and
    recon_mse, what its CLI writes). The port needs no conversion step."""
    src = tmp_path / "src.pt"
    if kind in ("adm", "v2"):
        unet = P.adm.ADMUNet(**SMALL_UNET, device="cpu")
        if kind == "adm":
            sd = _random_sd(unet, 48)
            torch.save(sd, src)
            got = tckpt.load_strict(
                P.adm.ADMUNet(**SMALL_UNET, device="cpu"),
                tckpt.load_torch_checkpoint(str(src))).state_dict()
            params = jckpt.convert_adm_state_dict(
                jckpt.load_torch_checkpoint(str(src)))
        else:
            v2 = P.adm.ADMUNetV2(unet)
            sd = _random_sd(v2, 49)
            ema = {f"model_ema.{k}": v for k, v in sd.items()}
            stale = {f"model.{k}": torch.zeros_like(v) for k, v in sd.items()}
            torch.save({"state_dict": {**ema, **stale}, "epoch": 3}, src)
            got = tckpt.load_v2(P.adm.ADMUNetV2(P.adm.ADMUNet(
                **SMALL_UNET, device="cpu")), tckpt.load_torch_checkpoint(
                    str(src))).state_dict()
            inner = jckpt.strip_prefix(
                jckpt.load_torch_checkpoint(str(src)), "model_ema.")
            params = {"unet": jckpt.convert_adm_state_dict(
                jckpt.strip_prefix(inner, "inner_model.")),
                "out_cov": jckpt.convert_v2_out_cov(inner)}
        back = P.weights.from_jax_params(params)
        assert set(back) <= set(got)
        for k, v in back.items():
            assert torch.equal(got[k], v), k
            assert torch.equal(got[k], sd[k]), k
    elif kind == "lpips":
        g = torch.Generator().manual_seed(50)
        vgg, layer, cin = {}, 0, 3
        for c in tmetrics.VGG16_CFG:
            if c == "M":
                layer += 1
                continue
            vgg[f"features.{layer}.weight"] = torch.randn(c, cin, 3, 3,
                                                          generator=g)
            vgg[f"features.{layer}.bias"] = torch.randn(c, generator=g)
            layer, cin = layer + 2, c
        lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
               for i, c in enumerate((64, 128, 256, 512, 512))}
        lin_path = tmp_path / "vgg_lin.pth"
        torch.save(vgg, src)
        torch.save(lin, lin_path)
        out = tmp_path / "lpips.npz"
        jconvert.main(["lpips", "--src", str(src), "--lin", str(lin_path),
                       "--out", str(out)])
        tree = tmetrics.convert_lpips_weights(
            tckpt.load_torch_checkpoint(str(src)),
            tckpt.load_torch_checkpoint(str(lin_path)))
        with np.load(out) as flat:
            assert set(flat.files) == {f"{m}.{n}" for m, sub in tree.items()
                                       for n in sub}
            for m, sub in tree.items():
                for n, v in sub.items():
                    np.testing.assert_array_equal(v, flat[f"{m}.{n}"])
    elif kind == "inception":
        model = tinc.InceptionV3Features()
        sd = _random_sd(model, 51)
        g = torch.Generator().manual_seed(52)
        sd["fc.weight"] = torch.randn(1008, 2048, generator=g)
        sd["fc.bias"] = torch.randn(1008, generator=g)
        torch.save(sd, src)
        variables = jinc.convert_inception_state_dict(
            jckpt.load_torch_checkpoint(str(src)))
        back = P.weights.inception_from_jax_params(variables)
        x = torch.rand(1, 3, 75, 75, generator=g) * 2 - 1
        got = tinc.make_inception_extractor(
            tckpt.load_torch_checkpoint(str(src)), device="cpu")(x)
        want = tinc.make_inception_extractor(back, device="cpu")(x)
        assert torch.isfinite(got).all() and torch.equal(got, want)
        for k, v in back.items():
            assert torch.equal(sd[k], v), k
    else:
        sig = torch.from_numpy(np.geomspace(1e-2, 80, 9).astype(np.float32))
        torch.save({"sigmas": sig, "mse_list": sig ** 0.5}, src)
        out = tmp_path / "recon_mse.npz"
        jconvert.main(["recon_mse", "--src", str(src), "--out", str(out)])
        for got in (tcli._recon_mse(str(src)), tcli._recon_mse(str(out))):
            with np.load(out) as want:
                for k in ("sigmas", "mse_list"):
                    np.testing.assert_array_equal(got[k], want[k])
