"""The port's Winograd F(2,3) ops (`kdip_tpu_torch.ops.winograd`) and their
layer (`models.layers.Conv2d`, `GroupNorm32.affine_terms`) against
`kdip_tpu`'s, on the CPU: the weight transform, the plain conv against the
Pallas kernel (`winograd_conv3x3_pallas(..., interpret=True)`, as
tests/test_winograd.py runs it) with and without the fused prologue, in
float32 and bfloat16, and the autograd of both ops against `jax.grad` of
the Pallas ops' custom VJPs. Inputs are numpy draws from a seed; NHWC/HWIO
arrays meet the port's NCHW/OIHW tensors through `nchw`/`nhwc`/`oihw`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kdip_tpu.models import layers as jlayers
from kdip_tpu.ops.experimental import winograd as jwino
from kdip_tpu.ops.experimental import winograd_pallas as jwp
from kdip_tpu_torch.models import layers as tlayers
from kdip_tpu_torch.ops import winograd as Wg
from test_torch_port import nchw, nhwc


def oihw(w_hwio) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1)))


def draws(B, H, W, C, Fo, seed, w_scale=0.2):
    """x NHWC, kernel HWIO, and the prologue's a, b [B, C], float32."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (w_scale * rng.standard_normal((3, 3, C, Fo))).astype(np.float32)
    a = (1.0 + 0.5 * rng.standard_normal((B, C))).astype(np.float32)
    b = (0.3 * rng.standard_normal((B, C))).astype(np.float32)
    return x, w, a, b


def pallas(x, w, a=None, b=None, dtype=jnp.float32):
    """kdip_tpu's Pallas conv in interpret mode; x cast to `dtype`, the
    weight transformed from its float32 values as SplitSkipConv does."""
    pro = None if a is None else (jnp.asarray(a), jnp.asarray(b))
    return np.asarray(jwp.winograd_conv3x3_pallas(
        jnp.asarray(x).astype(dtype), jnp.asarray(w), prologue=pro,
        interpret=True).astype(jnp.float32))


def port(x, w, a=None, b=None, dtype=torch.float32):
    pro = None if a is None else (torch.from_numpy(a), torch.from_numpy(b))
    return nhwc(Wg.winograd_conv3x3(nchw(x).to(dtype), oihw(w).to(dtype),
                                    prologue=pro))


def test_kernel_transform_matches():
    """V = G g G^T in float32: exact products by 0, +-1/2, +-1/4, sums of
    up to 9 terms in another order (atol 1e-7 on |V| ~ 1); rounded to bf16
    the two agree bit for bit or by one ulp where the float32 sums straddle
    a rounding boundary (none at this seed)."""
    _, w, _, _ = draws(1, 2, 2, 24, 16, seed=0, w_scale=1.0)
    v_j = np.asarray(jwino.kernel_transform(jnp.asarray(w)))
    v_t = Wg.kernel_transform(oihw(w)).numpy()
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-7)
    v_jb = np.asarray(jwino.kernel_transform(jnp.asarray(w), jnp.bfloat16)
                      .astype(jnp.float32))
    v_tb = Wg.kernel_transform(oihw(w), torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(v_tb, v_jb)


@pytest.mark.parametrize("case", ["plain", "prologue", "chunked"])
def test_plain_matches_pallas_f32(case):
    """float32: atol 5e-5 on outputs of magnitude ~5 (test_winograd.py:
    156-166, 232-243); with C=160, F=140, where kdip_tpu cuts C and F into
    chunks of 128 and sums the chunks, atol 5e-4 (test_winograd.py:168-180)."""
    if case == "chunked":
        x, w, a, b = draws(1, 8, 8, 160, 140, seed=1, w_scale=0.1)
        a = b = None
        atol = 5e-4
    else:
        x, w, a, b = draws(2, 12, 8, 16, 24, seed=2)
        if case == "plain":
            a = b = None
        atol = 5e-5
    np.testing.assert_allclose(port(x, w, a, b), pallas(x, w, a, b),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
def test_plain_matches_pallas_bf16(prologue):
    """bfloat16, the torso's dtype: both round the input transform's two
    stages, the prologue's affine and SiLU, and the output at the same
    places, from the same bf16 weight transform. Only the float32 order of
    the products' sums (and the float32 SiLU's last bits) differ, so each
    output is equal or one bf16 ulp apart (|d| <= 2^-7 |y|), but for
    outputs so small that the float32 noise of their terms decides
    (+ 2^-14 max|y|); at least 95% are bit-equal (measured: all of them,
    with and without the prologue)."""
    x, w, a, b = draws(2, 16, 12, 32, 24, seed=3)
    if not prologue:
        a = b = None
    w = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    y_j = pallas(x, w, a, b, dtype=jnp.bfloat16)
    y_t = port(x, w, a, b, dtype=torch.bfloat16)
    tol = 2 ** -7 * np.abs(y_j) + 2 ** -14 * np.abs(y_j).max()
    assert (np.abs(y_t - y_j) <= tol).all()
    assert (y_t == y_j).mean() >= 0.95


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
def test_autograd_matches_jax_grad(prologue):
    """d/dx, d/dW (and d/da, d/db) of sum(sin(conv)) against jax.grad of
    the Pallas op's custom VJP, float32, atol 3e-4 on gradients of
    magnitude ~10 (test_winograd.py:246-266)."""
    x, w, a, b = draws(1, 8, 8, 16, 16, seed=4)

    def loss_j(x, w, a, b):
        pro = (a, b) if prologue else None
        return jnp.sum(jnp.sin(jwp.winograd_conv3x3_pallas(
            x, w, prologue=pro, interpret=True)))

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t) for t in (x, w, a, b)))
    xt, wt = nchw(x).requires_grad_(True), oihw(w).requires_grad_(True)
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = Wg.winograd_conv3x3(xt, wt, prologue=(at, bt) if prologue else None)
    wrt = [xt, wt, at, bt] if prologue else [xt, wt]
    g_t = torch.autograd.grad(torch.sin(y).sum(), wrt)
    np.testing.assert_allclose(nhwc(g_t[0]), np.asarray(g_j[0]), rtol=0,
                               atol=3e-4)
    np.testing.assert_allclose(g_t[1].numpy().transpose(2, 3, 1, 0),
                               np.asarray(g_j[1]), rtol=0, atol=3e-4)
    if prologue:
        for got, want in zip(g_t[2:], g_j[2:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=3e-4)


def test_groupnorm_affine_terms_match():
    """GroupNorm32.affine_terms against kdip_tpu's return_affine on a bf16
    input, float32 statistics on both sides (atol 1e-5 on a, b ~ 1), and
    its apply equals the module's forward bit for bit."""
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    params = {"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}
    a_j, b_j = jlayers.GroupNorm32().apply(params, xb, return_affine=True)
    gn = tlayers.GroupNorm32(64)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    xt = nchw(x).to(torch.bfloat16)
    a_t, b_t = gn.affine_terms(xt)
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(b_t.detach().numpy(), np.asarray(b_j),
                               rtol=0, atol=1e-5)
    applied = (xt.float() * a_t[:, :, None, None]
               + b_t[:, :, None, None]).to(torch.bfloat16)
    assert torch.equal(applied, gn(xt))


def test_conv_module_routing():
    """Conv2d(winograd=True): an eligible bf16 call runs the Winograd op
    (within bf16 drift of the direct conv, relative 5e-2 as
    test_winograd.py:151); an odd H or W, or a float32 weight, takes the
    direct conv with the prologue applied unfused, exactly as the plain
    module computes it. The state dict is nn.Conv2d's."""
    torch.manual_seed(0)
    m = tlayers.Conv2d(16, 8, 3, torch.float32, winograd=True)
    assert list(m.state_dict()) == ["weight", "bias"]
    a, b = 1 + 0.3 * torch.randn(1, 16), 0.3 * torch.randn(1, 16)
    x = torch.randn(1, 16, 7, 9)
    direct = torch.nn.Conv2d(16, 8, 3, padding=1)
    direct.load_state_dict(m.state_dict())
    with torch.no_grad():
        assert torch.equal(m(x, (a, b)), direct(Wg.affine_silu(x, a, b)))
        xe = torch.randn(1, 16, 8, 10)
        assert torch.equal(m(xe), direct(xe))  # float32: direct path
        m.to(torch.bfloat16)
        y = m(xe.to(torch.bfloat16), (a, b)).float()
        ref = F.conv2d(Wg.affine_silu(xe, a, b), m.weight.float(),
                       m.bias.float(), padding=1)
    assert (y - ref).abs().max() <= 5e-2 * ref.abs().max()
    assert m._transforms[0] is not None  # the transforms were cached
