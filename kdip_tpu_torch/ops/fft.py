"""FFT-domain blur and SR math over NCHW tensors (port of
`kdip_tpu/ops/fft.py:23-119`; ref: condition/diffpir_utils/utils_sisr.py):
PSF -> OTF, the OTF's circular convolution, s-fold up/down-sampling and
the aliasing-block `splits`. On the card the transforms are cuFFT's, through
torch.fft; they stay complex-to-complex, as the reference's are.

OTFs are [H, W] complex64 and broadcast over [B, C, H, W].
"""

from __future__ import annotations

import numpy as np
import torch

_SPATIAL = (-2, -1)  # H, W of NCHW


def fft2(x: torch.Tensor) -> torch.Tensor:
    """2-D FFT over H and W."""
    return torch.fft.fftn(x, dim=_SPATIAL)


def ifft2(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifftn(x, dim=_SPATIAL)


def fft2c(x: torch.Tensor) -> torch.Tensor:
    """Centred orthonormal 2-D FFT over H and W
    (ref: dps_utils/fastmri_utils.py fft2c_new)."""
    x = torch.fft.ifftshift(x, dim=_SPATIAL)
    x = torch.fft.fftn(x, dim=_SPATIAL, norm="ortho")
    return torch.fft.fftshift(x, dim=_SPATIAL)


def ifft2c(x: torch.Tensor) -> torch.Tensor:
    """Inverse of fft2c."""
    x = torch.fft.ifftshift(x, dim=_SPATIAL)
    x = torch.fft.ifftn(x, dim=_SPATIAL, norm="ortho")
    return torch.fft.fftshift(x, dim=_SPATIAL)


def psf_to_otf_np(psf, shape) -> np.ndarray:
    """Host-side PSF -> OTF (numpy, complex64), bit-equal to
    `kdip_tpu.ops.fft.psf_to_otf_np`: the kernel in the top-left corner of
    an (H, W) plane, rolled by -(h//2, w//2) so its centre sits at the
    origin, then the FFT."""
    psf = np.asarray(psf)
    h, w = psf.shape[-2:]
    H, W = shape
    otf = np.zeros(psf.shape[:-2] + (H, W), psf.dtype)
    otf[..., :h, :w] = psf
    otf = np.roll(otf, (-(h // 2), -(w // 2)), axis=(-2, -1))
    return np.fft.fftn(otf, axes=(-2, -1)).astype(np.complex64)


def psf_to_otf(psf: torch.Tensor, shape) -> torch.Tensor:
    """psf_to_otf_np on psf's device (ref: utils_sisr.py:22-41 `p2o`)."""
    h, w = psf.shape[-2:]
    H, W = shape
    otf = psf.new_zeros(psf.shape[:-2] + (H, W))
    otf[..., :h, :w] = psf
    otf = torch.roll(otf, (-(h // 2), -(w // 2)), dims=_SPATIAL)
    return torch.fft.fftn(otf, dim=_SPATIAL)


def apply_otf(x: torch.Tensor, otf: torch.Tensor) -> torch.Tensor:
    """Circular convolution real(ifft2(otf * fft2(x))) of NCHW x."""
    return ifft2(otf * fft2(x)).real


def splits(a: torch.Tensor, sf: int) -> torch.Tensor:
    """[B, C, H, W] -> the sf*sf aliasing blocks [B, C, H/sf, W/sf, sf*sf]
    (ref: utils_sisr.py:9-19), last index w_chunk * sf + h_chunk, as
    `kdip_tpu.ops.fft.splits` orders them."""
    B, C, H, W = a.shape
    b = a.reshape(B, C, sf, H // sf, sf, W // sf)
    b = b.permute(0, 1, 3, 5, 4, 2)  # [B, C, H/sf, W/sf, sf_w, sf_h]
    return b.reshape(B, C, H // sf, W // sf, sf * sf)


def upsample(x: torch.Tensor, sf: int = 3) -> torch.Tensor:
    """s-fold zero-filling upsampler (ref: utils_sisr.py:44-52):
    out[..., i*sf, j*sf] = x[..., i, j], zeros elsewhere."""
    if sf == 1:
        return x
    H, W = x.shape[-2:]
    out = x.new_zeros(x.shape[:-2] + (H * sf, W * sf))
    out[..., ::sf, ::sf] = x
    return out


def downsample(x: torch.Tensor, sf: int = 3) -> torch.Tensor:
    """s-fold downsampler keeping the top-left pixel of each sf x sf patch
    (ref: utils_sisr.py:55-61)."""
    if sf == 1:
        return x
    return x[..., ::sf, ::sf]
