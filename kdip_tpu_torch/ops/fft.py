"""FFT-domain blur and SR math over NCHW tensors (port of
`kdip_tpu/ops/fft.py`; ref: condition/diffpir_utils/utils_sisr.py):
PSF -> OTF, the OTF's circular convolution, s-fold up/down-sampling, the
aliasing-block `splits`, and DiffPIR's FFT quadruple (`pre_calculate`),
closed-form data solution (`data_solution`), wrap-blur degradation and
half-pixel shift. On the card the transforms are cuFFT's, through
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


def pre_calculate(y: torch.Tensor, psf: torch.Tensor, sf: int):
    """The FFT quadruple the sampler's iterations reuse
    (ref: utils_sisr.py:79-96): y [B, C, h, w], the low-resolution (or,
    at sf 1, same-size) measurement, psf [kh, kw] on y's device. Returns
    (FB, FBC, F2B, FBFy): FB, FBC and F2B [H, W] = [h sf, w sf], FBFy
    [B, C, H, W] complex."""
    h, w = y.shape[-2:]
    FB = psf_to_otf(psf, (h * sf, w * sf))
    FBC = torch.conj_physical(FB)
    F2B = torch.abs(FB) ** 2
    FBFy = FBC * fft2(upsample(y, sf=sf))
    return FB, FBC, F2B, FBFy


def data_solution(x: torch.Tensor, FB, FBC, F2B, FBFy, alpha,
                  sf: int) -> torch.Tensor:
    """DiffPIR's closed-form proximal step (ref: utils_sisr.py:65-76):
    argmin_z |y - S H z|^2 + alpha |z - x|^2, diagonalised by the FFT.
    alpha is clipped below at 1e-2."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device
                            ).clamp(min=1e-2)
    FR = FBFy + fft2(alpha * x)
    FBR = splits(FB * FR, sf).mean(-1)
    invW = splits(torch.broadcast_to(F2B, x.shape).to(FB.dtype), sf).mean(-1)
    invWBR = FBR / (invW + alpha)
    FCBinvWBR = FBC * invWBR.repeat(1, 1, sf, sf)
    return ifft2((FR - FCBinvWBR) / alpha).real


def classical_degradation(x: torch.Tensor, k, sf: int = 3) -> torch.Tensor:
    """The classical SR degradation, circular (wrap) blur then s-fold
    subsampling (ref: utils_sisr.py:99-113, scipy.ndimage.convolve with
    mode='wrap'), as a product in the Fourier domain: x [..., H, W],
    k [kh, kw] numpy. psf_to_otf's corner placement and roll centre the
    kernel as ndimage.convolve does, for odd and even sizes."""
    psf = torch.as_tensor(np.asarray(k), dtype=x.dtype, device=x.device)
    return apply_otf(x, psf_to_otf(psf, x.shape[-2:]))[..., ::sf, ::sf]


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """The half-pixel grid shift that aligns bicubic SR kernels
    (ref: utils_sisr.py:117-143; its scipy interp2d(kind='linear') as a
    bilinear resample, axis by axis), numpy float64 on [H, W(, C)]."""
    x = np.array(x, dtype=np.float64)
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    xv = np.arange(w, dtype=np.float64)
    yv = np.arange(h, dtype=np.float64)
    x1 = np.clip(xv + (shift if upper_left else -shift), 0, w - 1)
    y1 = np.clip(yv + (shift if upper_left else -shift), 0, h - 1)

    def interp_axis(arr, coords, axis):
        i0 = np.floor(coords).astype(int)
        i1 = np.minimum(i0 + 1, arr.shape[axis] - 1)
        t = coords - i0
        a0 = np.take(arr, i0, axis=axis)
        a1 = np.take(arr, i1, axis=axis)
        tshape = [1] * arr.ndim
        tshape[axis] = len(coords)
        return a0 + (a1 - a0) * t.reshape(tshape)

    return interp_axis(interp_axis(x, y1, 0), x1, 1)
