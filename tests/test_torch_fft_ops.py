"""The port's FFT, resize and degradation-kernel helpers
(`kdip_tpu_torch.ops.fft`, `.resize`, `.kernels`) against `kdip_tpu`'s, on
numpy inputs from a seed, NCHW against NHWC.

Tolerances: the host-side numpy pieces (psf_to_otf_np, resize_matrix, the
gaussian, bicubic and motion kernels, the committed motion PSF) are
bit-equal, since they are the same numpy code. The FFTs are float32
complex on both sides, pocketfft (torch) against XLA's CPU FFT, whose sums
run in other orders: a unit-scale result within FFT_TOL = 2e-5 (measured
<= 5e-7; the OTF's convolution 9e-8), the unnormalised fft2, whose
outputs reach ~36 on these inputs, within 8 FFT_TOL (measured 6e-6).
upsample, downsample and splits only move values: bit-equal. The resize's
two float32 contractions: within 1e-6 (measured 9e-8).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu.ops import fft as jfft
from kdip_tpu.ops import kernels as jk
from kdip_tpu.ops import resize as jr
from kdip_tpu_torch.ops import fft as tfft
from kdip_tpu_torch.ops import kernels as tk
from kdip_tpu_torch.ops import resize as tr
from test_torch_port import REPO, nchw, nhwc

FFT_TOL = 2e-5
MOTION_NPY = os.path.join(REPO, "kdip_tpu_torch", "data",
                          "motion_ks61_i0.5_seed0.npy")


def _x(shape=(2, 12, 16, 3), seed=0, dtype=np.float32):
    """A non-symmetric NHWC input: H != W, B and C > 1."""
    return np.random.RandomState(seed).standard_normal(shape).astype(dtype)


def _c(z: torch.Tensor) -> np.ndarray:
    """The port's complex NCHW tensor as NHWC complex64."""
    return np.ascontiguousarray(z.numpy().transpose(0, 2, 3, 1))


@pytest.mark.parametrize("fn", ["fft2", "ifft2", "fft2c", "ifft2c"])
def test_fft_pair_matches(fn):
    x = _x()
    z = (x + 1j * _x(seed=1)).astype(np.complex64)
    for inp in (x, z):
        want = np.asarray(getattr(jfft, fn)(jnp.asarray(inp)))
        t_in = torch.from_numpy(
            np.ascontiguousarray(inp.transpose(0, 3, 1, 2)))
        got = _c(getattr(tfft, fn)(t_in))
        np.testing.assert_allclose(got, want, atol=FFT_TOL * 8)


def test_psf_to_otf_bit_equal_and_on_device():
    """The numpy OTF bit for bit, and the torch one within FFT_TOL, for odd
    and even kernels (the roll centres both)."""
    rng = np.random.RandomState(2)
    for kshape in ((7, 7), (8, 6), (9, 9)):
        psf = rng.uniform(0, 1, kshape).astype(np.float32)
        psf /= psf.sum()
        want = jfft.psf_to_otf_np(psf, (16, 20))
        got = tfft.psf_to_otf_np(psf, (16, 20))
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(got, want)
        on_dev = tfft.psf_to_otf(torch.from_numpy(psf), (16, 20)).numpy()
        np.testing.assert_allclose(on_dev, want, atol=FFT_TOL)


def test_apply_otf_matches():
    psf = tk.gaussian_kernel(7, 1.5).astype(np.float32)
    otf = jfft.psf_to_otf_np(psf, (12, 16))
    x = _x()
    want = np.asarray(jfft.apply_otf(jnp.asarray(x), jnp.asarray(otf)))
    got = nhwc(tfft.apply_otf(nchw(x), torch.from_numpy(otf)))
    np.testing.assert_allclose(got, want, atol=FFT_TOL)


@pytest.mark.parametrize("sf", [1, 2, 4])
def test_up_down_sample_bit_equal(sf):
    x = _x((2, 4, 5, 3))
    for name in ("upsample", "downsample"):
        want = np.asarray(getattr(jfft, name)(jnp.asarray(x), sf))
        np.testing.assert_array_equal(nhwc(getattr(tfft, name)(nchw(x), sf)),
                                      want)
    z = (x + 1j * x[::-1]).astype(np.complex64)
    want = np.asarray(jfft.upsample(jnp.asarray(z), sf))
    got = tfft.upsample(torch.from_numpy(
        np.ascontiguousarray(z.transpose(0, 3, 1, 2))), sf)
    np.testing.assert_array_equal(_c(got), want)


@pytest.mark.parametrize("sf", [2, 4])
def test_splits_block_order_bit_equal(sf):
    """kdip_tpu's [B, H/sf, W/sf, C, sf^2] against the port's
    [B, C, H/sf, W/sf, sf^2], on a non-symmetric input: a wrong block order
    would still give plausible images downstream."""
    x = _x((2, 4 * sf, 3 * sf, 3), seed=3)
    want = np.asarray(jfft.splits(jnp.asarray(x), sf))
    got = tfft.splits(nchw(x), sf).numpy().transpose(0, 2, 3, 1, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", [None, "cubic", "lanczos2", "lanczos3",
                                    "box", "linear"])
def test_resize_matrix_bit_equal(kernel):
    for n, o, s in ((16, 4, 0.25), (17, 6, 1 / 3), (8, 16, 2.0), (9, 9, 1.0)):
        for aa in (True, False):
            np.testing.assert_array_equal(
                tr.resize_matrix(n, o, s, kernel, aa),
                jr.resize_matrix(n, o, s, kernel, aa))


def test_make_resizer_matches():
    x = _x((2, 16, 12, 3), seed=4)
    jfn, (jMh, jMw) = jr.make_resizer((16, 12), 0.25)
    tfn, (tMh, tMw) = tr.make_resizer((16, 12), 0.25, device="cpu")
    np.testing.assert_array_equal(tMh.numpy(), np.asarray(jMh))
    np.testing.assert_array_equal(tMw.numpy(), np.asarray(jMw))
    want = np.asarray(jfn(jnp.asarray(x)))
    got = nhwc(tfn(nchw(x)))
    assert got.shape == (2, 4, 3, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(nhwc(tr.resize(nchw(x), 0.5)),
                               np.asarray(jr.resize(jnp.asarray(x), 0.5)),
                               atol=1e-6)


@pytest.mark.parametrize("size,std", [(61, 3.0), (9, 1.5), (8, 2.0)])
def test_gaussian_kernel_bit_equal(size, std):
    k = tk.gaussian_kernel(size, std)
    np.testing.assert_array_equal(k, jk.gaussian_kernel(size, std))
    assert abs(k.sum() - 1) < 1e-12


@pytest.mark.parametrize("sf", [2, 3, 4])
def test_bicubic_kernel_bit_equal(sf):
    k = tk.bicubic_kernel(sf)
    assert k.shape == (4 * sf + 1,) * 2
    np.testing.assert_array_equal(k, jk.bicubic_kernel(sf))


@pytest.mark.parametrize("intensity", [0.0, 0.3, 0.5, 1.0])
def test_motion_blur_kernel_bit_equal(intensity):
    for seed in (0, 1, 7):
        for size in (9, 61):
            np.testing.assert_array_equal(
                tk.motion_blur_kernel(size, intensity, seed=seed),
                jk.motion_blur_kernel(size, intensity, seed=seed))


def test_committed_motion_psf_is_kdip_tpus():
    """The PSF the card loads (it has no PIL) is kdip_tpu's
    motion_blur_kernel(61, 0.5, seed=0), float32, bit for bit."""
    k = np.load(MOTION_NPY)
    assert k.dtype == np.float32 and k.shape == (61, 61)
    np.testing.assert_array_equal(k, jk.motion_blur_kernel(61, 0.5, seed=0))
    np.testing.assert_array_equal(tk.load_kernel_npy(MOTION_NPY),
                                  jk.load_kernel_npy(MOTION_NPY))


def test_motion_kernel_without_pil_says_what_to_pass(monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="kernel_path="):
        tk.motion_blur_kernel(9, 0.5, seed=0)


def test_load_bicubic_mat(tmp_path):
    from scipy import io as sio
    ks = np.empty((1, 3), dtype=object)
    for i in range(3):
        ks[0, i] = np.random.RandomState(i).uniform(size=(5 + i, 5 + i))
    path = str(tmp_path / "k.mat")
    sio.savemat(path, {"kernels": ks})
    for sf in (2, 3, 4, 5):
        np.testing.assert_array_equal(tk.load_bicubic_mat(path, sf),
                                      jk.load_bicubic_mat(path, sf))
