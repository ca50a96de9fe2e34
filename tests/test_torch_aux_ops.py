"""The port's auxiliary ops (`kdip_tpu_torch.ops.inpaint`, `.deblur`, the
DiffPIR half of `.fft`, the fspecial zoo of `.kernels`, `.image_utils`,
`.dps_tools`, `.conv_mxu`) against `kdip_tpu`'s, on numpy inputs from a
seed, NCHW against NHWC.

Tolerances: numpy code that the port keeps as `kdip_tpu` has it (the PSF
and OTF helpers, the kernel zoo, shift_pixel, the imresize matrices, PSNR,
SSIM, YCbCr, the flow colouring) is bit-equal. Index moves (augment,
patches, masks, shifts) are bit-equal. The float32 FFT paths, pocketfft
against XLA's CPU FFT, agree to FFT_TOL = 2e-5 at unit scale (the DST-I's
unnormalised sums, which reach ~60 here, to 8 FFT_TOL); the harmonic
completion of the boundary pad (three DST-I solves) to 1e-5 of its unit
range. Float32 products and sums in another order (the shifted adds of
shepard_initialize, the imresize products, the conv formulations, the TV
loss) agree to 1e-5 or better; each test states its own bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kdip_tpu.ops import conv_mxu as jconv
from kdip_tpu.ops import deblur as jdb
from kdip_tpu.ops import dps_tools as jdps
from kdip_tpu.ops import fft as jfft
from kdip_tpu.ops import image_utils as jiu
from kdip_tpu.ops import inpaint as jinp
from kdip_tpu.ops import kernels as jk
from kdip_tpu_torch.ops import conv_mxu as tconv
from kdip_tpu_torch.ops import deblur as tdb
from kdip_tpu_torch.ops import dps_tools as tdps
from kdip_tpu_torch.ops import fft as tfft
from kdip_tpu_torch.ops import image_utils as tiu
from kdip_tpu_torch.ops import inpaint as tinp
from kdip_tpu_torch.ops import kernels as tk
from test_torch_port import nchw, nhwc, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FFT_TOL = 2e-5


def _u(shape, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, shape).astype(np.float32)


def _n(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _chw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(2, 0, 1)))


# ---------------------------------------------------------------------------
# ops.inpaint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,window,p", [((13, 17, 3), 5, 2),
                                            ((12, 10), 4, 2),
                                            ((9, 11, 1), 7, 4)])
def test_shepard_initialize_matches(shape, window, p):
    """The reference's asymmetric window, the validity masks at the edges
    and pixels with no measured neighbour (left 0): within 1e-6."""
    img = _u(shape)
    mask = (np.random.RandomState(1).uniform(size=shape[:2]) > 0.7
            ).astype(np.float32)
    want = np.asarray(jinp.shepard_initialize(jnp.asarray(img),
                                              jnp.asarray(mask), window, p))
    t_img = torch.from_numpy(img) if img.ndim == 2 else _chw(img)
    got = tinp.shepard_initialize(t_img, torch.from_numpy(mask), window, p)
    got = got.numpy() if img.ndim == 2 else got.numpy().transpose(1, 2, 0)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.array_equal(got[mask > 0], img[mask > 0])


def test_get_rho_sigma_bit_equal():
    for args in ((), (0.05, 10, 5.0)):
        for a, b in zip(tinp.get_rho_sigma(*args), jinp.get_rho_sigma(*args)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ops.deblur
# ---------------------------------------------------------------------------

def test_deblur_numpy_helpers_bit_equal():
    k = jk.fspecial_gaussian(7, 1.5)
    for shape in ((7, 7), (16, 20)):
        np.testing.assert_array_equal(tdb.zero_pad(k, shape),
                                      jdb.zero_pad(k, shape))
    np.testing.assert_array_equal(tdb.zero_pad(k, (9, 9), "center"),
                                  jdb.zero_pad(k, (9, 9), "center"))
    otf = tdb.psf2otf(k, (16, 20))
    np.testing.assert_array_equal(otf, jdb.psf2otf(k, (16, 20)))
    np.testing.assert_array_equal(tdb.otf2psf(otf, (7, 7)),
                                  jdb.otf2psf(otf, (7, 7)))
    n = np.arange(1, 300, 7)
    np.testing.assert_array_equal(tdb.opt_fft_size(n), jdb.opt_fft_size(n))


@pytest.mark.parametrize("dim", [0, 1])
def test_dst1_pair_matches(dim):
    """DST-I against kdip_tpu's and against its definition in float64,
    and idst1(dst1(x)) == x."""
    x = _n((6, 9))
    want = np.asarray(jdb.dst1(jnp.asarray(x), axis=dim))
    got = tdb.dst1(torch.from_numpy(x), dim).numpy()
    np.testing.assert_allclose(got, want, atol=8 * FFT_TOL)
    n = x.shape[dim]
    j = np.arange(n)
    basis = 2 * np.sin(np.pi * np.outer(j + 1, j + 1) / (n + 1))
    exact = np.moveaxis(np.tensordot(basis, np.moveaxis(x, dim, 0), 1), 0,
                        dim)
    np.testing.assert_allclose(got, exact, atol=8 * FFT_TOL)
    back = tdb.idst1(tdb.dst1(torch.from_numpy(x), dim), dim).numpy()
    np.testing.assert_allclose(back, x, atol=FFT_TOL)


@pytest.mark.parametrize("shape,size", [((12, 10), (16, 16)),
                                        ((9, 13, 3), (16, 20))])
def test_wrap_boundary_liu_matches(shape, size):
    """The padded image within 1e-5 (three DST-I solves), the image itself
    bit-equal in the top-left corner; and solve_min_laplacian keeps its
    frame."""
    img = _u(shape)
    want = np.asarray(jax.jit(jdb.wrap_boundary_liu, static_argnums=1)(
        jnp.asarray(img), size))
    t_img = torch.from_numpy(img) if img.ndim == 2 else _chw(img)
    got = tdb.wrap_boundary_liu(t_img, size).numpy()
    if img.ndim == 3:
        got = got.transpose(1, 2, 0)
    assert got.shape == want.shape == tuple(size) + shape[2:]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[:shape[0], :shape[1]], img)
    b = torch.from_numpy(_u((7, 9), 3))
    s = tdb.solve_min_laplacian(b)
    frame = torch.ones_like(b, dtype=torch.bool)
    frame[1:-1, 1:-1] = False
    assert torch.equal(s[frame], b[frame])
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jdb.solve_min_laplacian(jnp.asarray(b.numpy()))),
        atol=1e-5)


# ---------------------------------------------------------------------------
# ops.fft: DiffPIR's quadruple, data solution, degradation, pixel shift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf", [1, 2, 4])
def test_pre_calculate_and_data_solution_match(sf):
    """FB, FBC, F2B and FBFy within FFT_TOL (FBFy, an unnormalised FFT
    product reaching ~40, within 8 FFT_TOL); the closed-form solution
    within FFT_TOL, at a scalar alpha and below the 1e-2 clip."""
    k = jk.fspecial_gaussian(5, 1.2).astype(np.float32)
    y = _u((2, 16 // sf, 12 // sf, 3), 1)
    x = _n((2, 16, 12, 3), 2)
    jq = jfft.pre_calculate(jnp.asarray(y), jnp.asarray(k), sf)
    tq = tfft.pre_calculate(nchw(y), torch.from_numpy(k), sf)
    for name, j, t, tol in zip(("FB", "FBC", "F2B"), jq[:3], tq[:3],
                               (FFT_TOL,) * 3):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(tq[3].numpy().transpose(0, 2, 3, 1),
                               np.asarray(jq[3]), atol=8 * FFT_TOL)
    for alpha in (0.37, 1e-3):
        want = np.asarray(jfft.data_solution(jnp.asarray(x), *jq, alpha, sf))
        got = nhwc(tfft.data_solution(nchw(x), *tq, alpha, sf))
        np.testing.assert_allclose(got, want, atol=FFT_TOL * 10)


@pytest.mark.parametrize("ksize,sf", [(5, 3), (4, 2)])
def test_classical_degradation_matches(ksize, sf):
    """Odd and even kernels: kdip_tpu's and scipy's wrap convolution,
    subsampled, within FFT_TOL."""
    from scipy import ndimage
    k = np.random.RandomState(4).uniform(size=(ksize, ksize))
    k /= k.sum()
    x = _u((12, 15, 3), 5)
    want = np.asarray(jfft.classical_degradation(jnp.asarray(x), k, sf))
    got = tfft.classical_degradation(_chw(x), k, sf).numpy()
    np.testing.assert_allclose(got.transpose(1, 2, 0), want, atol=FFT_TOL)
    ref = ndimage.convolve(x.astype(np.float64), k[..., None],
                           mode="wrap")[::sf, ::sf]
    np.testing.assert_allclose(got.transpose(1, 2, 0), ref, atol=FFT_TOL)


def test_shift_pixel_bit_equal():
    x = _u((10, 12, 3))
    for sf, ul in ((2, True), (3, False), (4, True)):
        np.testing.assert_array_equal(tfft.shift_pixel(x, sf, ul),
                                      jfft.shift_pixel(x, sf, ul))


# ---------------------------------------------------------------------------
# ops.kernels: the fspecial zoo and the trajectory PSF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("average", 5), ("disk", 3), ("gaussian", 9, 2.0), ("laplacian", 0.3),
    ("log", 7, 1.1), ("motion", 9, 30.0), ("motion", 6, 135.0),
    ("motion", 5, 90.0), ("prewitt",), ("sobel",)], ids=str)
def test_fspecial_bit_equal(args):
    np.testing.assert_array_equal(tk.fspecial(*args), jk.fspecial(*args))


def test_trajectory_kernels_bit_equal():
    """rot3d, random_trajectory, kernel_from_trajectory and
    blurkernel_synthesis from one RandomState seed each: bit-equal."""
    r = np.array([0.3, -1.2, 2.0])
    v = np.array([1.0, 2.0, -0.5])
    np.testing.assert_array_equal(tk.rot3d(v, r), jk.rot3d(v, r))
    np.testing.assert_array_equal(tk.fspecial_gauss(4, 1.0),
                                  jk.fspecial_gauss(4, 1.0))
    for seed in (0, 5):
        tx = tk.random_trajectory(np.random.RandomState(seed), 40)
        jx = jk.random_trajectory(np.random.RandomState(seed), 40)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(
            tk.kernel_from_trajectory(np.random.RandomState(seed + 1), tx),
            jk.kernel_from_trajectory(np.random.RandomState(seed + 1), jx))
        np.testing.assert_array_equal(tk.blurkernel_synthesis(25, seed=seed),
                                      jk.blurkernel_synthesis(25, seed=seed))


def test_load_levin_kernels_matches(tmp_path):
    """An HDF5 file laid out as Levin09.mat (a 'kernels' array of object
    references): the same normalised kernels."""
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "levin.mat"
    rng = np.random.RandomState(6)
    with h5py.File(path, "w") as f:
        refs = []
        for i, s in enumerate((5, 7, 9, 11)):
            refs.append(f.create_dataset(f"k{i}", data=rng.uniform(
                size=(s, s + 2))).ref)
        f.create_dataset("kernels", data=np.array(refs, dtype=object
                                                  ).reshape(2, 2),
                         dtype=h5py.ref_dtype)
    got, want = tk.load_levin_kernels(path), jk.load_levin_kernels(path)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ops.image_utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.25, 0.5, 1 / 3, 2.0, 4.0])
def test_imresize_matches(scale):
    """The matrices bit-equal; the numpy path bit-equal; the tensor path
    ([B, C, H, W], two float32 products) within 1e-5 of kdip_tpu's jnp
    einsums and of the float64 numpy result."""
    for n in (13, 24):
        np.testing.assert_array_equal(tiu.imresize_matrix(n, scale),
                                      jiu.imresize_matrix(n, scale))
    x = _u((24, 20, 3))
    np.testing.assert_array_equal(tiu.imresize(x, scale),
                                  jiu.imresize(x, scale))
    want = np.asarray(jiu.imresize(jnp.asarray(x), scale))
    got = tiu.imresize(_chw(x)[None], scale)[0].numpy().transpose(1, 2, 0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, jiu.imresize(x, scale), atol=1e-5)


def test_image_metrics_and_colour_bit_equal():
    a = (_u((20, 22, 3)) * 255).round().astype(np.uint8)
    b = np.clip(a.astype(int) + np.random.RandomState(1).randint(
        -9, 10, a.shape), 0, 255).astype(np.uint8)
    for border in (0, 2):
        assert tiu.calculate_psnr(a, b, border) == jiu.calculate_psnr(
            a, b, border)
        assert tiu.calculate_ssim(a, b, border) == jiu.calculate_ssim(
            a, b, border)
    assert tiu.calculate_ssim(a[..., 0], b[..., 0]) == jiu.calculate_ssim(
        a[..., 0], b[..., 0])
    f = _u((8, 6, 3))
    for img in (a, f):
        for fn in ("rgb2ycbcr", "bgr2ycbcr"):
            for only_y in (True, False):
                np.testing.assert_array_equal(
                    getattr(tiu, fn)(img, only_y), getattr(jiu, fn)(img, only_y))
        np.testing.assert_array_equal(tiu.ycbcr2rgb(img), jiu.ycbcr2rgb(img))
    for fn in ("uint2single", "uint162single"):
        np.testing.assert_array_equal(getattr(tiu, fn)(a), getattr(jiu, fn)(a))
    for fn in ("single2uint", "single2uint16"):
        np.testing.assert_array_equal(getattr(tiu, fn)(f), getattr(jiu, fn)(f))
    np.testing.assert_array_equal(tiu.modcrop(a, 4), jiu.modcrop(a, 4))
    np.testing.assert_array_equal(tiu.shave(a, 3), jiu.shave(a, 3))
    lst = [a, a[::-1].copy()]
    for in_c, tar in ((3, "gray"), (3, "y"), (1, "RGB")):
        src = [x[..., :1] for x in lst] if in_c == 1 else lst
        for g, w in zip(tiu.channel_convert(in_c, tar, src),
                        jiu.channel_convert(in_c, tar, src)):
            np.testing.assert_array_equal(g, w)


def test_image_converters_and_augment_match():
    """The numpy <-> tensor converters, CHW as the reference's, and the
    dihedral augments: bit-equal."""
    u8 = (_u((6, 5, 3)) * 255).round().astype(np.uint8)
    f = _u((6, 5, 3))
    f4 = _u((6, 5, 3, 2))
    cases = [("uint2tensor4", u8), ("uint2tensor3", u8),
             ("single2tensor4", f), ("single2tensor3", f),
             ("single2tensor5", f4), ("single42tensor4", f4),
             ("single32tensor5", f4[..., 0]), ("single2tensor2", f[..., :1])]
    for name, arg in cases:
        np.testing.assert_array_equal(getattr(tiu, name)(arg).numpy(),
                                      np.asarray(getattr(jiu, name)(arg)),
                                      err_msg=name)
    t = tiu.uint2tensor4(u8)
    for name in ("tensor2uint", "tensor2single", "tensor2single3",
                 "tensor2img"):
        np.testing.assert_array_equal(
            getattr(tiu, name)(t), getattr(jiu, name)(jnp.asarray(t.numpy())),
            err_msg=name)
    batch = torch.from_numpy(_u((4, 3, 6, 6)))
    np.testing.assert_array_equal(tiu.tensor2img(batch),
                                  jiu.tensor2img(batch.numpy()))
    x4 = _u((2, 3, 6, 5))
    for mode in range(8):
        np.testing.assert_array_equal(tiu.augment_img(f, mode),
                                      jiu.augment_img(f, mode))
        np.testing.assert_array_equal(tiu.augment_img_np3(f, mode),
                                      jiu.augment_img_np3(f, mode))
        np.testing.assert_array_equal(
            tiu.augment_img_tensor4(torch.from_numpy(x4), mode).numpy(),
            np.asarray(jiu.augment_img_tensor4(jnp.asarray(x4), mode)))
        for x in (x4, x4[0]):
            np.testing.assert_array_equal(
                tiu.augment_img_tensor(torch.from_numpy(x), mode).numpy(),
                np.asarray(jiu.augment_img_tensor(jnp.asarray(x), mode)))
    g, w = (m.augment_imgs([f, f], rng=np.random.RandomState(3))
            for m in (tiu, jiu))
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)


def test_imread_imsave_match(tmp_path):
    """An RGB and a grey PNG read without PIL, and a JPEG through PIL, as
    kdip_tpu reads them through PIL (n_channels 3 and 1): bit-equal; imsave
    writes what imread reads; the file-system helpers list the same
    files."""
    from PIL import Image
    rgb = (_u((12, 9, 3)) * 255).round().astype(np.uint8)
    grey = rgb[..., 1]
    Image.fromarray(rgb).save(tmp_path / "a.png")
    Image.fromarray(grey).save(tmp_path / "b.png")
    Image.fromarray(rgb).save(tmp_path / "c.jpg", quality=90)
    for name in ("a.png", "b.png", "c.jpg"):
        for n in (3, 1):
            got = tiu.imread_uint(str(tmp_path / name), n)
            want = jiu.imread_uint(str(tmp_path / name), n)
            assert got.shape == want.shape and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {n}")
    np.testing.assert_array_equal(tiu.read_img(str(tmp_path / "a.png")),
                                  jiu.read_img(str(tmp_path / "a.png")))
    tiu.imsave(rgb, str(tmp_path / "d.png"))
    np.testing.assert_array_equal(tiu.imread_uint(str(tmp_path / "d.png")),
                                  rgb)
    tiu.imsave(grey[..., None], str(tmp_path / "e.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "e.png")),
                                  grey)
    assert tiu.get_image_paths(str(tmp_path)) == jiu.get_image_paths(
        str(tmp_path))
    tiu.mkdirs([str(tmp_path / "x"), str(tmp_path / "y" / "z")])
    assert os.path.isdir(tmp_path / "y" / "z")


# ---------------------------------------------------------------------------
# ops.dps_tools
# ---------------------------------------------------------------------------

def test_bbox_and_masks_match_on_kdip_tpu_draws():
    """random_bbox and bbox2mask / mask_image fed the draws kdip_tpu makes
    from its key (tools.py:106-152): the same boxes, masks (hole and
    mosaic) and crops."""
    key = jax.random.key(3)
    jb = jdps.random_bbox(key, (32, 32), (12, 10), (2, 3), batch_size=3,
                          mask_batch_same=False)
    tb = tdps.random_bbox((32, 32), (12, 10), (2, 3), batch_size=3,
                          mask_batch_same=False, tops=jb[:, 0],
                          lefts=jb[:, 1])
    np.testing.assert_array_equal(tb, jb)
    same = tdps.random_bbox((32, 32), (12, 10), batch_size=2,
                            generator=torch.Generator().manual_seed(0))
    assert (same[0] == same[1]).all() and 0 <= same[0, 0] < 20
    deltas = []
    for i in range(3):
        kh, kw = jax.random.split(jax.random.fold_in(key, i))
        deltas.append([int(jax.random.randint(kh, (), 0, 3)),
                       int(jax.random.randint(kw, (), 0, 2))])
    x = _n((3, 32, 32, 2), 1)
    for mtype in ("hole", "mosaic"):
        jr, jm = jdps.mask_image(key, jnp.asarray(x), jb, (32, 32), (5, 3),
                                 mtype, 4)
        tr, tm = tdps.mask_image(nchw(x), tb, (32, 32), (5, 3), mtype, 4,
                                 deltas=np.array(deltas))
        np.testing.assert_array_equal(nhwc(tm), np.asarray(jm))
        np.testing.assert_array_equal(nhwc(tr), np.asarray(jr))
    crops = jdps.local_patch(jnp.asarray(x), jb)
    np.testing.assert_array_equal(nhwc(tdps.local_patch(nchw(x), tb)),
                                  np.asarray(crops))
    np.testing.assert_array_equal(
        tdps.spatial_discounting_mask((6, 7)).numpy()[0, 0],
        np.asarray(jdps.spatial_discounting_mask((6, 7)))[0, ..., 0])


@pytest.mark.parametrize("ks,st,rt,pad", [((3, 3), (1, 1), (1, 1), "same"),
                                          ((4, 3), (2, 3), (1, 2), "same"),
                                          ((3, 5), (2, 1), (1, 1), "valid")])
def test_extract_image_patches_matches(ks, st, rt, pad):
    """kdip_tpu's [B, nH, nW, kh*kw*C] (kh, kw, c) against the reference's
    Unfold layout [B, C*kh*kw, nH*nW] (c, kh, kw): the same values."""
    x = _n((2, 11, 13, 3), 2)
    want = np.asarray(jdps.extract_image_patches(jnp.asarray(x), ks, st, rt,
                                                 pad))
    got = tdps.extract_image_patches(nchw(x), ks, st, rt, pad).numpy()
    B, nH, nW, _ = want.shape
    want = want.reshape(B, nH * nW, ks[0], ks[1], 3).transpose(0, 4, 2, 3, 1)
    np.testing.assert_array_equal(got, want.reshape(B, -1, nH * nW))


def test_fold_unfold_match():
    x = _n((2, 16, 16, 3), 3)
    jp = jdps.unfold_patches(jnp.asarray(x), 8, 4)
    tp = tdps.unfold_patches(nchw(x), 8, 4)
    np.testing.assert_array_equal(tp.permute(0, 1, 3, 4, 2).numpy(),
                                  np.asarray(jp))
    np.testing.assert_allclose(nhwc(tdps.fold_patches(tp, 16, 4)),
                               np.asarray(jdps.fold_patches(jp, 16, 4)),
                               atol=1e-6)
    _, back = tdps.fold_unfold(nchw(x), 8, 4)
    np.testing.assert_allclose(nhwc(back), x, atol=1e-6)
    np.testing.assert_allclose(
        nhwc(back), np.asarray(jdps.fold_unfold(jnp.asarray(x), 8, 4)[1]),
        atol=1e-6)


def test_centred_ffts_and_normalisations_match():
    """fft2c / ifft2c (complex as a last axis of 2), the shifts and roll
    within FFT_TOL or bit-equal; the quantile normalisations, the TV loss,
    the reducers and the log-densities within 1e-5 relative."""
    z = _n((2, 3, 10, 12, 2), 4)
    for fn in ("fft2c", "ifft2c"):
        np.testing.assert_allclose(
            getattr(tdps, fn)(torch.from_numpy(z)).numpy(),
            np.asarray(getattr(jdps, fn)(jnp.asarray(z))), atol=FFT_TOL)
    back = tdps.ifft2c(tdps.fft2c(torch.from_numpy(z))).numpy()
    np.testing.assert_allclose(back, z, atol=FFT_TOL)
    x = _n((2, 3, 9, 8), 5)
    for a, b in ((tdps.fftshift(torch.from_numpy(x), (-2, -1)),
                  jdps.fftshift(jnp.asarray(x), (-2, -1))),
                 (tdps.ifftshift(torch.from_numpy(x), (-2, -1)),
                  jdps.ifftshift(jnp.asarray(x), (-2, -1))),
                 (tdps.roll(torch.from_numpy(x), (2, -3), (-2, -1)),
                  jdps.roll(jnp.asarray(x), (2, -3), (-2, -1)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for fn in ("unnormalize", "normalize_quantile", "dynamic_thresholding"):
        np.testing.assert_allclose(getattr(tdps, fn)(xt, 0.9).numpy(),
                                   np.asarray(getattr(jdps, fn)(xj, 0.9)),
                                   rtol=1e-5, atol=1e-6)
    img = _n((2, 9, 8, 3), 6)
    np.testing.assert_allclose(
        float(tdps.total_variation_loss(nchw(img), 0.3)),
        float(jdps.total_variation_loss(jnp.asarray(img), 0.3)), rtol=1e-5)
    for fn in ("reduce_mean", "reduce_std", "reduce_sum"):
        for axis in (None, [1, 3]):
            np.testing.assert_allclose(
                getattr(tdps, fn)(xt, axis, True).numpy(),
                np.asarray(getattr(jdps, fn)(xj, axis, True)), rtol=1e-5,
                atol=1e-6)
    y = _n((2, 3, 9, 8), 7)
    A = (lambda v: 0.5 * v)
    np.testing.assert_allclose(
        float(tdps.log_py_given_x0(xt, torch.from_numpy(y), A, 0.7, 5)),
        float(jdps.log_py_given_x0(xj, jnp.asarray(y), A, 0.7, 5)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tdps.log_pxt_given_x0(xt, torch.from_numpy(y), 0.3, 4)),
        float(jdps.log_pxt_given_x0(xj, jnp.asarray(y), 0.3, 4)), rtol=1e-5)
    np.testing.assert_allclose(tdps.clear_color(xt[:1]),
                               jdps.clear_color(np.asarray(x[:1])))
    np.testing.assert_array_equal(tdps.deprocess(xt).numpy(),
                                  np.asarray(jdps.deprocess(xj)))


def test_flow_colouring_and_numpy_helpers_bit_equal(tmp_path):
    flow = _n((2, 6, 6, 2), 8) * 3
    flow[0, 0, 0] = np.nan
    np.testing.assert_array_equal(tdps.flow_to_image(flow),
                                  jdps.flow_to_image(flow))
    hl = np.clip(np.abs(_n((1, 5, 5, 2), 9)) * 2, 0, 4.9)
    np.testing.assert_array_equal(tdps.highlight_flow(hl),
                                  jdps.highlight_flow(hl))
    np.testing.assert_array_equal(tdps.make_color_wheel(),
                                  jdps.make_color_wheel())
    np.testing.assert_array_equal(tdps.create_penalty_mask(9, 0.5),
                                  jdps.create_penalty_mask(9, 0.5))
    img = _u((9, 12, 3))
    np.testing.assert_array_equal(tdps.center_crop(img, 6, 5),
                                  jdps.center_crop(img, 6, 5))
    for name in ("gen_00001000.pt", "gen_00002000.pt", "dis_00002000.pt"):
        (tmp_path / name).write_bytes(b"")
    for it in (0, 1000, 3000):
        assert tdps.get_model_list(str(tmp_path), "gen", it) == \
            jdps.get_model_list(str(tmp_path), "gen", it)
    assert tdps.find_nearest([0.1, 0.5, 0.9], 0.6) == 1


def test_grad_and_value_matches():
    """DPS's norm and its gradient through an operator and a denoiser:
    within 1e-5 relative."""
    x = _n((1, 8, 8, 3), 10)
    y = _n((1, 8, 8, 3), 11)
    w = _n((3, 3), 12) * 0.3
    jg, jn = jdps.grad_and_value(lambda v: 0.5 * v,
                                 lambda v: jnp.tanh(v @ jnp.asarray(w)),
                                 jnp.asarray(x), jnp.asarray(y))
    tw = torch.from_numpy(w)
    tg, tn = tdps.grad_and_value(
        lambda v: 0.5 * v,
        lambda v: torch.tanh(torch.einsum("bchw,cd->bdhw", v, tw)),
        nchw(x), nchw(y))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    np.testing.assert_allclose(nhwc(tg), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# ops.conv_mxu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["conv3x3_nchw", "conv3x3_nhwc",
                                "conv3x3_im2col"])
def test_conv_formulations_match(fn):
    """Each formulation against F.conv2d and kdip_tpu's same-named one, with
    and without a bias: within 2e-5 (float32 sums of 9 C terms in another
    order)."""
    x = _n((2, 9, 7, 16), 13)
    k = _n((3, 3, 16, 5), 14) * 0.2
    b = _n((5,), 15)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    for bias in (None, b):
        tb = None if bias is None else torch.from_numpy(bias)
        got = getattr(tconv, fn)(nchw(x), wt, tb)
        np.testing.assert_allclose(got.numpy(),
                                   F.conv2d(nchw(x), wt, tb, padding=1).numpy(),
                                   atol=2e-5)
        want = getattr(jconv, fn)(jnp.asarray(x), jnp.asarray(k),
                                  None if bias is None else jnp.asarray(bias))
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-5)
