"""Boundary handling and OTF / PSF helpers for classic deconvolution (port
of `kdip_tpu/ops/deblur.py`; ref: condition/diffpir_utils/utils_deblur.py):

- `wrap_boundary_liu` (ref: utils_deblur.py:300-379) pads an image to an
  FFT size with a smooth wrap-around border (Liu and Jia, ICIP 2008), so a
  circular deconvolution shows no seam. Its Poisson solve
  (`solve_min_laplacian`, ref: utils_deblur.py:382-438) diagonalises the
  Laplacian with a type-I DST, computed here through an odd-extended
  `torch.fft.rfft` on the tensor's device (cuFFT on the card), where the
  reference calls scipy.fftpack on the host;
- `opt_fft_size` (ref: utils_deblur.py:250-297): the 2/3/5/7-smooth (times
  11 or 13) FFT length at or above n;
- `psf2otf` / `otf2psf` / `zero_pad` (ref: utils_deblur.py:123-242): numpy,
  at set-up time.

Images are [H, W] or NCHW-style [C, H, W] tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "zero_pad", "psf2otf", "otf2psf", "opt_fft_size",
    "dst1", "idst1", "solve_min_laplacian", "wrap_boundary",
    "wrap_boundary_liu",
]


# ---------------------------------------------------------------------------
# PSF <-> OTF (numpy, set-up time; the device version is ops.fft.psf_to_otf)
# ---------------------------------------------------------------------------

def zero_pad(image: np.ndarray, shape, position: str = "corner") -> np.ndarray:
    """Zero-extend a 2D array to `shape` (ref: utils_deblur.py:203-242)."""
    shape = np.asarray(shape, dtype=int)
    imshape = np.asarray(image.shape, dtype=int)
    if np.array_equal(imshape, shape):
        return image
    if np.any(shape <= 0):
        raise ValueError("zero_pad: null or negative shape")
    dshape = shape - imshape
    if np.any(dshape < 0):
        raise ValueError("zero_pad: target smaller than source")
    if position == "center":
        if np.any(dshape % 2 != 0):
            raise ValueError("zero_pad: shape parity mismatch for center")
        off = dshape // 2
    else:
        off = np.zeros_like(dshape)
    out = np.zeros(tuple(shape), dtype=image.dtype)
    out[off[0]:off[0] + imshape[0], off[1]:off[1] + imshape[1]] = image
    return out


def psf2otf(psf: np.ndarray, shape=None) -> np.ndarray:
    """PSF -> OTF with center-to-origin circular shift
    (ref: utils_deblur.py:154-200)."""
    if shape is None:
        shape = psf.shape
    if np.all(psf == 0):
        return np.zeros(tuple(np.asarray(shape, dtype=int)))
    if psf.ndim == 1:
        psf = psf[None, :]
    inshape = psf.shape
    padded = zero_pad(psf, shape, position="corner")
    for axis, axis_size in enumerate(inshape):
        padded = np.roll(padded, -(axis_size // 2), axis=axis)
    otf = np.fft.fft2(padded, axes=(0, 1))
    n_ops = np.sum(padded.size * np.log2(padded.shape))
    return np.real_if_close(otf, tol=n_ops)


def otf2psf(otf: np.ndarray, outsize=None) -> np.ndarray:
    """OTF -> PSF, optional center crop (ref: utils_deblur.py:123-150)."""
    insize = np.array(otf.shape)
    psf = np.fft.ifftn(otf, axes=(0, 1))
    for axis, axis_size in enumerate(insize):
        psf = np.roll(psf, int(np.floor(axis_size / 2)), axis=axis)
    if outsize is not None:
        outsize = np.asarray(outsize, dtype=int)
        pad = (insize - outsize) / 2
        if np.any(pad < 0):
            raise ValueError("otf2psf: outsize must be <= otf size")
        start = np.floor(pad).astype(int)
        end = (insize - np.ceil(pad)).astype(int)
        psf = psf[start[0]:end[0], start[1]:end[1]]
    n_ops = np.sum(otf.size * np.log2(otf.shape))
    return np.real_if_close(psf, tol=n_ops)


@functools.lru_cache(maxsize=1)
def _opt_fft_size_lut(lut_size: int = 2048) -> np.ndarray:
    """Smallest 2^a·3^b·5^c·7^d·{1,11,13} length >= n, for n <= lut_size
    (ref: utils_deblur.py:250-297)."""
    smooth = np.zeros(lut_size + 1, dtype=np.int64)
    e2 = 1
    while e2 <= lut_size:
        e3 = e2
        while e3 <= lut_size:
            e5 = e3
            while e5 <= lut_size:
                e7 = e5
                while e7 <= lut_size:
                    smooth[e7] = e7
                    if e7 * 11 <= lut_size:
                        smooth[e7 * 11] = e7 * 11
                    if e7 * 13 <= lut_size:
                        smooth[e7 * 13] = e7 * 13
                    e7 *= 7
                e5 *= 5
            e3 *= 3
        e2 *= 2
    # forward-fill: entry n = smallest smooth number >= n
    best = 0
    for n in range(lut_size, 0, -1):
        if smooth[n]:
            best = smooth[n]
        smooth[n] = best
    return smooth


def opt_fft_size(n: Sequence[int]) -> np.ndarray:
    """Vector version of the reference's LUT lookup
    (ref: utils_deblur.py:290-297); -1 above the LUT range."""
    lut = _opt_fft_size_lut()
    n = np.asarray(n, dtype=np.int64)
    out = np.where(n <= len(lut) - 1, lut[np.minimum(n, len(lut) - 1)], -1)
    return out.astype(np.float64)


# ---------------------------------------------------------------------------
# DST-I through an odd-extended FFT (replaces scipy.fftpack.dst / idst)
# ---------------------------------------------------------------------------

def dst1(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Type-I discrete sine transform in scipy.fftpack.dst(type=1)'s
    convention, y_k = 2 sum_j x_j sin(pi (j+1)(k+1) / (N+1)): minus the
    imaginary part of the length-2(N+1) rFFT of the odd extension
    [0, x, 0, -rev(x)]."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    zeros = x.new_zeros(x.shape[:-1] + (1,))
    ext = torch.cat([zeros, x, zeros, -x.flip(-1)], -1)
    out = -torch.fft.rfft(ext, dim=-1).imag[..., 1:n + 1]
    return out.movedim(-1, dim)


def idst1(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The inverse of dst1: dst1 / (2 (N + 1))."""
    return dst1(x, dim) / (2.0 * (x.shape[dim] + 1))


def solve_min_laplacian(boundary: torch.Tensor) -> torch.Tensor:
    """Fills the interior of `boundary` [h, w] (its values on the 1 px
    frame) with the harmonic completion, the 5-point Laplacian
    diagonalised by DST-I (ref: utils_deblur.py:382-438)."""
    h, w = boundary.shape
    frame = boundary.clone()
    frame[1:-1, 1:-1] = 0.0
    # the frame's contribution to the interior Laplacian; the rhs is -it
    f_bp = (-4.0 * frame[1:-1, 1:-1] + frame[1:-1, 2:] + frame[1:-1, :-2]
            + frame[:-2, 1:-1] + frame[2:, 1:-1])
    tt = dst1(-f_bp, 1) / 2.0
    f2sin = dst1(tt, 0) / 2.0
    dev, dt = boundary.device, boundary.dtype
    x = torch.arange(1, w - 1, dtype=dt, device=dev)
    y = torch.arange(1, h - 1, dtype=dt, device=dev)
    denom = ((2.0 * torch.cos(math.pi * x[None, :] / (w - 1)) - 2.0)
             + (2.0 * torch.cos(math.pi * y[:, None] / (h - 1)) - 2.0))
    f3 = f2sin / denom
    tt = idst1(2.0 * f3, 0)
    frame[1:-1, 1:-1] = idst1(2.0 * tt, 1)
    return frame


def _ramp(first: torch.Tensor, last: torch.Tensor, n: int) -> torch.Tensor:
    a = torch.linspace(0.0, 1.0, n, dtype=first.dtype, device=first.device)
    return (1 - a) * first + a * last


def wrap_boundary(img: torch.Tensor, img_size) -> torch.Tensor:
    """Pads one channel [h, w] to `img_size` with a smooth wrap-around
    border (ref: utils_deblur.py:315-379, the alpha = 1 path)."""
    h, w = img.shape
    hw_ = int(img_size[0]) - h
    ww_ = int(img_size[1]) - w
    # the vertical strip between the bottom and the (wrapped) top rows
    r_a = img.new_zeros((2 + hw_, w))
    r_a[0], r_a[-1] = img[-1], img[0]
    r_a[1:-1, 0] = _ramp(r_a[0, 0], r_a[-1, 0], hw_)
    r_a[1:-1, -1] = _ramp(r_a[0, -1], r_a[-1, -1], hw_)
    # the horizontal strip between the right and the (wrapped) left columns
    r_b = img.new_zeros((h, 2 + ww_))
    r_b[:, 0], r_b[:, -1] = img[:, -1], img[:, 0]
    r_b[0, 1:-1] = _ramp(r_b[0, 0], r_b[0, -1], ww_)
    r_b[-1, 1:-1] = _ramp(r_b[-1, 0], r_b[-1, -1], ww_)
    r_a = solve_min_laplacian(r_a)
    r_b = solve_min_laplacian(r_b)
    # the corner block, stitched from the two strips
    r_c = img.new_zeros((2 + hw_, 2 + ww_))
    r_c[0], r_c[-1] = r_b[-1], r_b[0]
    r_c[:, 0], r_c[:, -1] = r_a[:, -1], r_a[:, 0]
    r_c = solve_min_laplacian(r_c)
    top = torch.cat([img, r_b[:, 1:-1]], 1)
    bottom = torch.cat([r_a[:-2, :], r_c[1:-1, 1:-1]], 1)
    return torch.cat([top, bottom], 0)


def wrap_boundary_liu(img: torch.Tensor, img_size) -> torch.Tensor:
    """wrap_boundary of each channel of [C, H, W], or of one [H, W]
    (ref: utils_deblur.py:300-312)."""
    if img.ndim == 2:
        return wrap_boundary(img, img_size)
    return torch.stack([wrap_boundary(c, img_size) for c in img])
