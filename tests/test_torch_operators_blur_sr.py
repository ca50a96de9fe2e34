"""The port's denoising, colorization, gaussian/motion blur and bicubic
super-resolution operators (`kdip_tpu_torch.operators`) against
`kdip_tpu.operators`, NCHW against NHWC, built from the same configs.

Tolerances: the OTFs, PSFs and resize matrices are built by the same numpy
code, so they are bit-equal. Every image an operator makes is held within
OP_TOL = 2e-6 of kdip_tpu's, for unit-scale images: the channel mean
rounds a 3-term float32 sum (measured 6e-8), the blurs and the SR
transpose go through float32 complex FFTs whose sums run in other orders,
pocketfft against XLA's CPU FFT (measured <= 1.2e-7), the bicubic forward
through two float32 contractions (measured 6e-8). Adjointness in the
port, <Ax, y> = <x, A^T y>: relative 1e-5 in float32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kdip_tpu import operators as jops
from kdip_tpu_torch import operators as tops
from test_torch_port import REPO, nchw, nhwc

S = 32          # the SR PSF is 17 px and must fit the image
OP_TOL = 2e-6
NEW_OPS = {
    "noise": dict(sigma_s=0.05),
    "colorization": dict(sigma_s=0.05),
    "gaussian_blur": dict(in_shape=(1, 3, S, S), kernel_size=9,
                          intensity=1.5, sigma_s=0.05),
    "motion_blur": dict(in_shape=(1, 3, S, S), kernel_size=9, seed=3,
                        sigma_s=0.05),
    "super_resolution": dict(in_shape=(1, 3, S, S), scale_factor=4,
                             sigma_s=0.05),
}
YAMLS = ("gaussian_deblur_config.yaml", "motion_deblur_config.yaml",
         "super_resolution_4x_config.yaml", "inpainting_config.yaml")


def build(name, **extra):
    cfg = dict(NEW_OPS[name], **extra)
    return (jops.get_operator(name, **cfg),
            tops.get_operator(name, device="cpu", **cfg))


def _img(seed, shape=(2, S, S, 3)):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("name", list(NEW_OPS))
def test_forward_transpose_match(name):
    jop, top = build(name)
    assert top.name == jop.name == name
    x = _img(0)
    y_j = np.asarray(jop.forward(jnp.asarray(x)))
    y_t = nhwc(top.forward(nchw(x)))
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, atol=OP_TOL)
    y = _img(1, y_j.shape)
    np.testing.assert_allclose(nhwc(top.transpose(nchw(y))),
                               np.asarray(jop.transpose(jnp.asarray(y))),
                               atol=OP_TOL)


@pytest.mark.parametrize("name", ["gaussian_blur", "motion_blur",
                                  "super_resolution"])
def test_spectra_and_matrices_bit_equal(name):
    """kernel, FB, FBC, F2B (and the SR resize matrices) on the device, as
    kdip_tpu holds them."""
    jop, top = build(name)
    np.testing.assert_array_equal(top.kernel.numpy(), np.asarray(jop.kernel))
    assert top.FB.dtype == top.FBC.dtype == torch.complex64
    assert top.F2B.dtype == torch.float32
    np.testing.assert_array_equal(top.FB.numpy().real, np.asarray(jop.FB_re))
    np.testing.assert_array_equal(top.FB.numpy().imag, np.asarray(jop.FB_im))
    np.testing.assert_array_equal(top.FBC.numpy(), np.asarray(jop.FBC))
    np.testing.assert_array_equal(top.F2B.numpy(), np.asarray(jop.F2B))
    if name == "super_resolution":
        np.testing.assert_array_equal(top.Mh.numpy(), np.asarray(jop.Mh))
        np.testing.assert_array_equal(top.Mw.numpy(), np.asarray(jop.Mw))
        assert top.scale_factor == jop.scale_factor == 4


def _inner(a, b):
    return float((a.double() * b.double()).sum())


@pytest.mark.parametrize("name", list(NEW_OPS))
def test_adjoint_in_the_port(name):
    """<A x, y> = <x, A^T y>; for SR with A the FFT form (blur, then every
    sf-th pixel), whose adjoint the transpose is: the bicubic forward is
    not its adjoint's partner, as in the reference."""
    from kdip_tpu_torch.ops import fft as tfft
    _, top = build(name)
    x = nchw(_img(2))
    if name == "super_resolution":
        sf = top.scale_factor

        def A(v):
            return tfft.downsample(tfft.ifft2(top.FB * tfft.fft2(v)), sf).real
    else:
        A = top.forward
    y = nchw(_img(3, nhwc(A(x)).shape))
    lhs, rhs = _inner(A(x), y), _inner(x, top.transpose(y))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("name", list(NEW_OPS))
def test_measure_with_injected_noise(name):
    """y = A x + sigma_s n with kdip_tpu's own draw fed to the port."""
    jop, top = build(name)
    x = _img(4, (1, S, S, 3))
    key = jax.random.key(9)
    y_j = np.asarray(jop.measure(jnp.asarray(x), key).y)
    n = np.asarray(jax.random.normal(key, y_j.shape))
    y_t = nhwc(top.measure(nchw(x), noise=nchw(n)).y)
    np.testing.assert_allclose(y_t, y_j, atol=OP_TOL)
    # and from a generator: the shape of A x, sigma_s of noise around it
    g = torch.Generator().manual_seed(0)
    y_g = top.measure(nchw(x), generator=g).y
    assert tuple(y_g.shape) == tuple(nchw(y_j).shape)


@pytest.mark.parametrize("fname", YAMLS)
def test_get_operator_from_configs(fname):
    """Each operator yaml of configs/ builds in both packages at 32 px
    (blur kernels cut to 9 px, the motion kernel seeded) and the two agree
    on one image."""
    with open(os.path.join(REPO, "configs", fname)) as f:
        cfg = yaml.safe_load(f)
    cfg["in_shape"] = [1, 3, S, S]
    if "kernel_size" in cfg:
        cfg["kernel_size"] = 9
    if cfg["name"] == "motion_blur":
        cfg["seed"] = 0
    if cfg["name"] == "inpainting":
        cfg["mask_opt"]["image_size"] = S
        cfg["seed"] = 0
    name = cfg.pop("name")
    jop = jops.get_operator(name, **cfg)
    top = tops.get_operator(name, device="cpu", **cfg)
    assert top.name == name and top.sigma_s == pytest.approx(cfg["sigma_s"])
    x = _img(5, (1, S, S, 3))
    np.testing.assert_allclose(nhwc(top.forward(nchw(x))),
                               np.asarray(jop.forward(jnp.asarray(x))),
                               atol=OP_TOL)


def test_motion_blur_from_kernel_path_and_defaults():
    """kernel_path loads the packaged PSF (as the card does, without PIL);
    motion_blur's default intensity is 0.5, gaussian_blur's 3.0."""
    path = os.path.join(REPO, "kdip_tpu_torch", "data",
                        "motion_ks61_i0.5_seed0.npy")
    top = tops.get_operator("motion_blur", device="cpu", kernel_path=path,
                            in_shape=(1, 3, 64, 64))
    jop = jops.get_operator("motion_blur", kernel_path=path,
                            in_shape=(1, 3, 64, 64))
    np.testing.assert_array_equal(top.kernel.numpy(), np.asarray(jop.kernel))
    assert abs(float(top.kernel.sum()) - 1) < 1e-5
    d_t = tops.get_operator("motion_blur", device="cpu", kernel_size=9,
                            seed=1, in_shape=(1, 3, S, S))
    d_j = jops.get_operator("motion_blur", kernel_size=9, seed=1,
                            in_shape=(1, 3, S, S))
    np.testing.assert_array_equal(d_t.kernel.numpy(), np.asarray(d_j.kernel))
    g_t = tops.get_operator("gaussian_blur", device="cpu", kernel_size=9,
                            in_shape=(1, 3, S, S))
    g_j = jops.get_operator("gaussian_blur", kernel_size=9,
                            in_shape=(1, 3, S, S))
    np.testing.assert_array_equal(g_t.kernel.numpy(), np.asarray(g_j.kernel))


@pytest.mark.parametrize("fname", YAMLS[:3])
def test_chip_smoke_reads_the_operator_yamls(fname):
    """chip_smoke.py reads the flat operator files of configs/ without
    PyYAML (the card's machine may lack it), to what yaml.safe_load
    gives (inpainting's nested mask_opt it does not read)."""
    import chip_smoke
    with open(os.path.join(REPO, "configs", fname)) as f:
        want = yaml.safe_load(f)
    assert chip_smoke.load_op_config(fname) == want
    assert chip_smoke.load_op_config(fname, kernel_path="k.npy") == dict(
        want, kernel_path="k.npy")
