"""The rest of the port's ADM family (`kdip_tpu_torch.models.adm`) against
`kdip_tpu.models.adm`, on the CPU in float32: the UNet flags that the port
used to refuse (class_cond, resblock_updown=False with conv_resample on
and off, use_scale_shift_norm=False, num_heads_upsample), the classifier's
four pools through `create_classifier` with a classifier-guidance
gradient through `ddpm_sampling.condition_score`, and SuperResADMUNet;
then the bfloat16 Winograd torso without scale-shift norm, its plain
kernel against the direct conv. Weights are seeded random, carried by
`weights.from_jax_params` or `kdip_tpu.ckpt.convert_classifier_state_dict`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdip_tpu_torch as P
from kdip_tpu import ckpt as jckpt
from kdip_tpu import ddpm_sampling as jds
from kdip_tpu import diffusion as jd
from kdip_tpu.models import adm as jadm
from test_torch_port import SMALL_UNET, nchw, nhwc, random_flax_params

S = SMALL_UNET["image_size"]
FLAGS = {
    "class_cond": dict(num_classes=10),
    "no_updown_conv": dict(resblock_updown=False),
    "no_updown_pool": dict(resblock_updown=False, conv_resample=False),
    "no_scale_shift": dict(use_scale_shift_norm=False),
    "heads_upsample": dict(num_head_channels=-1, num_heads=4,
                           num_heads_upsample=2),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's small CPU ops on one thread (see test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-5):
    """Within rtol of the largest |want|: float32 on both sides with other
    conv and reduction orders (measured <= 3e-6)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def _inputs(seed=0, B=2, size=S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, size, size, 3), dtype=np.float32)
    t = np.array([10.5, 500.25][:B], np.float32)
    return x, t, rng


@pytest.mark.parametrize("case", list(FLAGS))
def test_unet_flag_matches_kdip_tpu(case):
    """forward and its vjp w.r.t. x at a random cotangent; class_cond
    with labels y (and a ValueError, kdip_tpu's assert, without them)."""
    kw = dict(SMALL_UNET, **FLAGS[case])
    x, t, rng = _inputs()
    ct = rng.standard_normal((2, S, S, 6), dtype=np.float32)
    y = np.array([3, 7]) if "num_classes" in kw else None
    jm = jadm.ADMUNet(**kw)
    args = (jnp.asarray(x), jnp.asarray(t)) + (
        () if y is None else (jnp.asarray(y),))
    params = random_flax_params(jm.init, *args, seed=1)
    tm = P.adm.ADMUNet(**kw, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params))
    f = jax.jit(lambda xx: jm.apply({"params": params}, xx, *args[1:]))
    y_j, vjp = jax.vjp(f, jnp.asarray(x))
    g_j = vjp(jnp.asarray(ct))[0]
    xt = nchw(x).requires_grad_(True)
    yt = None if y is None else torch.from_numpy(y)
    out = tm(xt, torch.from_numpy(t), y=yt)
    g_t, = torch.autograd.grad(out, xt, grad_outputs=nchw(ct))
    close(nhwc(out), y_j)
    close(nhwc(g_t), g_j)
    names = set(tm.state_dict())
    if case == "class_cond":
        assert tm.label_emb.weight.shape == (10, 4 * kw["model_channels"])
        with pytest.raises(ValueError, match="class label"):
            tm(xt, torch.from_numpy(t))
    if case == "no_updown_conv":
        assert "input_blocks.2.0.op.weight" in names
        assert "output_blocks.1.2.conv.weight" in names
    if case == "no_updown_pool":
        assert not any(".op." in k or k.endswith("conv.weight")
                       for k in names)
    if case == "no_scale_shift":
        assert tm.state_dict()["input_blocks.1.0.emb_layers.1.weight"
                               ].shape == (32, 128)


POOLS = ["adaptive", "attention", "spatial", "spatial_v2"]
CLS = dict(image_size=64, classifier_width=32, classifier_depth=1,
           classifier_attention_resolutions="8", out_channels=10)


@pytest.fixture(scope="module")
def tables():
    return (jd.make_diffusion(1000, "linear"),
            P.diffusion.make_diffusion(1000, "linear", device="cpu"))


@pytest.mark.parametrize("pool", POOLS)
def test_classifier_pool_and_guidance_gradient(pool, tables):
    """create_classifier at 64 px (width 32, depth 1): the port's seeded
    weights load into kdip_tpu through its convert_classifier_state_dict
    and come back through weights.classifier_from_jax_params bit for bit;
    the logits match, and so does the classifier-guidance step: the
    gradient of log p(y | x, t) fed to condition_score over the same
    p_mean_variance (within 1e-5 of the largest value)."""
    jt, tt = tables
    tm = P.adm.create_classifier(classifier_pool=pool, device="cpu", **CLS)
    P.weights.randomize_(tm, 8)
    sd = tm.state_dict()
    params = jckpt.convert_classifier_state_dict(sd, pool=pool)
    back = P.weights.classifier_from_jax_params(params)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    fresh = P.adm.create_classifier(classifier_pool=pool, device="cpu",
                                    **CLS)
    P.ckpt.load_strict(fresh, back)
    if pool == "attention":
        assert sd["out.2.positional_embedding"].shape == (128, 65)

    jm = jadm.create_classifier(classifier_pool=pool, **CLS)
    x, _, rng = _inputs(9, B=2, size=64)
    t = np.array([20, 600])
    labels = np.array([1, 4])
    logits_j = jax.jit(lambda xx: jm.apply({"params": params}, xx,
                                           jnp.asarray(t)))(jnp.asarray(x))
    with torch.no_grad():
        logits_t = fresh(nchw(x), torch.from_numpy(t))
    close(logits_t.numpy(), logits_j)

    @jax.jit
    def jcond(xx, tt_):
        def lp(z):
            lg = jm.apply({"params": params}, z, tt_)
            return jax.nn.log_softmax(lg)[jnp.arange(2), labels].sum()
        return jax.grad(lp)(xx)

    def tcond(xx, tt_):
        z = xx.detach().requires_grad_(True)
        lg = fresh(z, tt_)
        lp = torch.log_softmax(lg, -1)[torch.arange(2), labels].sum()
        return torch.autograd.grad(lp, z)[0]

    out = rng.standard_normal((2, 64, 64, 6), dtype=np.float32)
    pmv_j = jd.p_mean_variance(jt, jnp.asarray(out), jnp.asarray(x),
                               jnp.asarray(t))
    pmv_t = P.diffusion.p_mean_variance(tt, nchw(out), nchw(x),
                                        torch.from_numpy(t))
    close(nhwc(tcond(nchw(x), torch.from_numpy(t))),
          jcond(jnp.asarray(x), jnp.asarray(t)))
    got = P.ddpm_sampling.condition_score(tt, tcond, pmv_t, nchw(x),
                                          torch.from_numpy(t))
    want = jds.condition_score(jt, jcond, pmv_j, jnp.asarray(x),
                               jnp.asarray(t))
    for k in ("pred_xstart", "mean"):
        close(nhwc(got[k]), want[k])


def test_super_res_matches_kdip_tpu():
    """SuperResADMUNet: the 8 px low-res image upsampled bilinearly to 16
    px (F.interpolate against jax.image.resize) and concatenated onto x;
    the state dict is the UNet's, as guided-diffusion's subclass keeps it."""
    kw = dict(SMALL_UNET, in_channels=6)
    x, t, rng = _inputs(10)
    low = rng.uniform(-1, 1, (2, S // 2, S // 2, 3)).astype(np.float32)
    jm = jadm.SuperResADMUNet(unet=jadm.ADMUNet(**kw))
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(low), seed=11)
    tm = P.adm.SuperResADMUNet(**kw, device="cpu")
    tm.load_state_dict(P.weights.from_jax_params(params["unet"]))
    want = jax.jit(lambda a, b: jm.apply({"params": params}, a,
                                         jnp.asarray(t), low_res=b))(
        jnp.asarray(x), jnp.asarray(low))
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(t), low_res=nchw(low))
    close(nhwc(got), want)
    up = torch.nn.functional.interpolate(nchw(low), size=(S, S),
                                         mode="bilinear", align_corners=False)
    close(nhwc(up), jax.image.resize(jnp.asarray(low), (2, S, S, 3),
                                     "bilinear"))


def test_winograd_torso_without_scale_shift():
    """A 32 px bfloat16 torso with use_scale_shift_norm=False and
    winograd=True (the plain kernel on the CPU) against the same weights
    with the direct conv: every ResBlock's out_conv takes the fused
    prologue (the statistics of h + emb), and the output and x-vjp agree
    within the bf16 torso drift of test_torch_winograd_model.py, 0.1 of
    the largest value. The launch counts stay 0 on the CPU."""
    kw = dict(SMALL_UNET, image_size=32, use_scale_shift_norm=False)
    x, t, rng = _inputs(12, B=1, size=32)
    ct = rng.standard_normal((1, 32, 32, 6), dtype=np.float32)
    jm = jadm.ADMUNet(**kw)
    params = random_flax_params(jm.init, jnp.asarray(x), jnp.asarray(t[:1]),
                                seed=13)
    outs = {}
    for wino in (True, False):
        tm = P.adm.ADMUNet(**kw, device="cpu", winograd=wino)
        tm.load_state_dict(P.weights.from_jax_params(params))
        P.weights.precast_inference(tm)
        fused = []
        convs = [m for m in tm.modules() if isinstance(m, P.layers.Conv2d)]

        def record(xx, v, prologue=None):
            fused.append(prologue is not None)
            return P.winograd.winograd_conv3x3_plain(xx, v, prologue)
        for m in convs:
            m.conv_fn = record
        P.winograd.reset_launch_counts()
        xt = nchw(x).requires_grad_(True)
        y = tm(xt, torch.from_numpy(t[:1]))
        g, = torch.autograd.grad(y, xt, grad_outputs=nchw(ct))
        assert sum(P.winograd.launch_counts.values()) == 0
        outs[wino] = (nhwc(y), nhwc(g))
        blocks = [m for m in tm.modules() if isinstance(m, P.layers.ResBlock)]
        down = sum(b.down for b in blocks)
        if wino:
            # the forward: fused but in the down-blocks' in_conv; the
            # vjp's dx plain
            assert sum(fused) == 2 * len(blocks) - down
            assert len(fused) - sum(fused) == down + 2 * len(blocks)
        else:
            assert not fused
    for a, b in zip(outs[True], outs[False]):
        assert np.abs(b).max() > 1e-2
        assert float(np.abs(a - b).max()) <= 0.1 * float(np.abs(b).max())
