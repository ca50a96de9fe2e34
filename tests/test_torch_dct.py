"""The port's orthonormal DCT (`kdip_tpu_torch.ops.transforms.dct` / `idct`,
`OrthoTransform("dct")`) against `kdip_tpu`'s, which is
`jax.scipy.fft.dct(type=2, norm="ortho")` over every non-batch axis of
NHWC; the port transforms C, H and W of NCHW. Then the DCT-Var guided
denoise (the V2 head with `ortho_tf_type="dct"`, Type-I and Type-II)
against `kdip_tpu`'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy import fft as jfft

from kdip_tpu.ops import transforms as jtf
from kdip_tpu_torch.ops import transforms as T
from test_torch_guidance_modes import S, build
from test_torch_port import nchw, nhwc

# NHWC: square, non-square, non-symmetric sizes, C of 3 and of 1, B > 1
SHAPES = [(1, 16, 16, 3), (2, 12, 20, 3), (1, 7, 10, 1), (3, 9, 5, 2)]
# float32 matrix products against jax's float32 FFT-based DCT, per entry,
# relative to the largest: both round ~log2(n) terms' worth of sums
DCT_TOL = 2e-6


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dct_matches_jax_scipy(shape):
    """dct and idct against kdip_tpu's (jax.scipy.fft.dct / idct, type 2,
    ortho, every non-batch axis of size > 1), and against
    jax.scipy.fft.dct applied axis by axis here."""
    x = _x(shape, sum(shape))
    xj = jnp.asarray(x)
    want = np.asarray(jtf.dct(xj))
    direct = xj
    for axis in (1, 2, 3):
        if shape[axis] > 1:
            direct = jfft.dct(direct, type=2, norm="ortho", axis=axis)
    np.testing.assert_allclose(want, np.asarray(direct), atol=1e-6)
    scale = np.abs(want).max()
    np.testing.assert_allclose(nhwc(T.dct(nchw(x))) / scale, want / scale,
                               atol=DCT_TOL)
    want_i = np.asarray(jtf.idct(xj))
    scale = np.abs(want_i).max()
    np.testing.assert_allclose(nhwc(T.idct(nchw(x))) / scale, want_i / scale,
                               atol=DCT_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dct_round_trip_and_orthonormality(shape):
    """idct(dct(x)) == x and dct(idct(x)) == x; dct keeps inner products
    (<Dx, Dz> = <x, z>) and the matrix is orthonormal in float32; a
    channel axis of size 1 is left alone, as kdip_tpu skips it."""
    x, z = nchw(_x(shape, 1)), nchw(_x(shape, 2))
    np.testing.assert_allclose(T.idct(T.dct(x)).numpy(), x.numpy(),
                               atol=2e-6)
    np.testing.assert_allclose(T.dct(T.idct(x)).numpy(), x.numpy(),
                               atol=2e-6)
    ip = float((x * z).sum())
    np.testing.assert_allclose(float((T.dct(x) * T.dct(z)).sum()), ip,
                               rtol=1e-5, atol=1e-4)
    for n in set(shape[1:]):
        d = T._dct_matrix(n, torch.device("cpu"))
        np.testing.assert_allclose((d @ d.T).numpy(), np.eye(n), atol=1e-6)
    if shape[3] == 1:
        # one channel: the transform is that of each (H, W) plane alone
        assert torch.equal(T.dct(x), T._along(T._along(x, 2, False), 3,
                                              False))


def test_ortho_transform_dct():
    """OrthoTransform("dct") is dct / idct; ot_covariance and
    masked_cov_matvec with "dct" against kdip_tpu's compositions
    (guidance.py:394-395, transforms.py:190-198), theta per sample and
    repeating over the batch."""
    shape = (2, 16, 12, 3)
    v, theta = _x(shape, 3), np.abs(_x(shape, 4)) + 0.5
    mask = (np.random.RandomState(5).random_sample((1,) + shape[1:]) < 0.5
            ).astype(np.float32)
    s2 = float(np.float32(0.05) ** 2)
    ot = T.OrthoTransform("dct")
    assert torch.equal(ot(nchw(v)), T.dct(nchw(v)))
    assert torch.equal(ot.inv(nchw(v)), T.idct(nchw(v)))
    jot = jtf.OrthoTransform("dct")
    vj, mj = jnp.asarray(v), jnp.asarray(mask)
    for th in (theta, theta[:1]):
        tj = jnp.asarray(th)
        want = np.asarray(jtf.ot_covariance(jot, tj)(vj))
        got = nhwc(T.ot_covariance(ot, nchw(th))(nchw(v)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=DCT_TOL)
        want = np.asarray(s2 * vj + mj * jot.inv(tj * jot(vj)))
        got = nhwc(ot.masked_cov_matvec(nchw(v), nchw(th), nchw(mask), s2))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=DCT_TOL)


@pytest.mark.parametrize("guidance", ["I", "II"])
def test_dct_var_denoise_matches(guidance):
    """The DCT-Var configuration (configs/test_ffhq_dct.json under --v2:
    the V2 head, ortho_tf_type "dct", mle threshold 1.0) on p=0.5
    inpainting, one guided denoise at sigma 0.3 (CG through the DCT
    covariance) and 3.0 (the closed form): hat_x0 within 1e-3, the CG
    exit residuals within 0.1%, as test_torch_guidance_modes.py holds the
    DWT one."""
    gcfg = dict(guidance=guidance, ortho_tf_type="dct", mle_sigma_thres=1.0)
    jden, tden = build("inpainting", True, gcfg)
    rng = np.random.RandomState(11)
    xs = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    for sigma in (0.3, 3.0):
        x = xs + sigma * rng.standard_normal(xs.shape).astype(np.float32)
        out_j, info_j = jden(jnp.asarray(x), jnp.float32(sigma))
        out_t, info_t = tden(nchw(x), sigma)
        np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), atol=1e-3)
        r_j = float(info_j["cg_resid"])
        if sigma < 1.0:
            assert 0 < info_t["cg_resid"] <= 1e-4 and info_t["cg_iters"] > 0
        else:
            assert info_t == {"cg_resid": 0.0, "cg_iters": 0}
        np.testing.assert_allclose(info_t["cg_resid"], r_j, rtol=1e-3)


def test_dct_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="NCHW"):
        T.dct(torch.zeros(3, 8, 8))
    with pytest.raises(ValueError, match="unknown"):
        T.OrthoTransform("haar")
