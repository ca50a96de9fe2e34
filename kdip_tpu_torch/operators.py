"""Measurement operators y = A x + n (PyTorch port of `kdip_tpu/operators.py`;
ref: condition/measurements.py). NCHW images in [-1, 1].

Ported: denoising ("noise"), colorization, gaussian and motion blur,
bicubic super-resolution, random/box inpainting, the nonlinear phase
retrieval and nonlinear blur, and the clean, gaussian and poisson noise
models. Every operator's forward is differentiable (dps and stsl guidance
differentiate it). Randomness (measurement noise, the nonlinear blur's
kernel, poisson counts) is injected or drawn from a torch.Generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .ops import fft as offt
from .ops import kernels as okernels
from .ops import resize as oresize


@dataclasses.dataclass
class Measurement:
    """Per-image measurement state carried through the guided sampler:
    y in image layout [B, C, h, w]."""
    y: torch.Tensor


__OPERATOR__: Dict[str, Callable] = {}


def register_operator(name: str):
    def wrapper(factory):
        if name in __OPERATOR__:
            raise NameError(f"operator name {name!r} registered twice")
        __OPERATOR__[name] = factory
        return factory
    return wrapper


def get_operator(name: str, device="cuda", **kwargs):
    """Builds an operator from a config dict (the reference's YAML fields,
    ref: configs/*_config.yaml) on `device`."""
    if name not in __OPERATOR__:
        raise NameError(f"no operator registered under {name!r}")
    return __OPERATOR__[name](device=device, **kwargs)


def _nchw_shape_to_hw(in_shape) -> Tuple[int, int]:
    """The reference YAMLs carry NCHW in_shape tuples (1, 3, H, W)."""
    return int(in_shape[-2]), int(in_shape[-1])


class LinearOperator:
    """A linear A with its transpose; measure gives y = A x + sigma_s n."""

    def __init__(self, sigma_s: float):
        self.sigma_s = sigma_s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def transpose(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def measure(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Measurement:
        """y = A x + sigma_s * n, with n (standard normal, A x's shape)
        injected as `noise` or drawn from `generator`."""
        y = self.forward(x)
        if noise is None:
            noise = torch.randn(y.shape, generator=generator, device=y.device,
                                dtype=y.dtype)
        return Measurement(y=y + self.sigma_s * noise)


class DenoiseOperator(LinearOperator):
    """A = I, pure denoising (ref: measurements.py:55-70)."""
    name = "noise"

    def forward(self, x):
        return x

    def transpose(self, y):
        return y


@register_operator("noise")
def _build_denoise(sigma_s: float = 0.0, **_):
    return DenoiseOperator(sigma_s=float(np.float32(sigma_s)))


class ColorizationOperator(LinearOperator):
    """A = the channel mean (ref: measurements.py:73-83); A^T spreads y/3."""
    name = "colorization"

    def forward(self, x):
        return x.mean(dim=1, keepdim=True)

    def transpose(self, y):
        return y.repeat(1, 3, 1, 1) / 3.0


@register_operator("colorization")
def _build_colorization(sigma_s: float = 0.05, **_):
    return ColorizationOperator(sigma_s=float(np.float32(sigma_s)))


class _FFTKernel(LinearOperator):
    """An operator with a circular-convolution kernel: its PSF and its
    [H, W] OTF FB (complex64), FBC = conj(FB) and F2B = |FB|^2 (float32,
    FB_re^2 + FB_im^2 as `kdip_tpu` computes it), on one device."""

    def __init__(self, sigma_s: float, kernel: np.ndarray, hw, device):
        super().__init__(sigma_s)
        kernel = np.asarray(kernel, np.float32)
        FB = offt.psf_to_otf_np(kernel, hw)
        self.kernel = torch.from_numpy(kernel).to(device)
        self.FB = torch.from_numpy(FB).to(device)
        self.FBC = torch.from_numpy(np.conj(FB)).to(device)
        re = torch.from_numpy(FB.real.astype(np.float32)).to(device)
        im = torch.from_numpy(FB.imag.astype(np.float32)).to(device)
        self.F2B = re ** 2 + im ** 2


class BlurOperator(_FFTKernel):
    """Circular-convolution blur through its OTF (ref: measurements.py:125-199,
    the gaussian and motion variants)."""

    def __init__(self, sigma_s, kernel, hw, device, name="gaussian_blur"):
        super().__init__(sigma_s, kernel, hw, device)
        self.name = name

    def forward(self, x):
        return offt.ifft2(self.FB * offt.fft2(x)).real

    def transpose(self, y):
        return offt.ifft2(self.FBC * offt.fft2(y)).real


def _build_blur(name: str, in_shape=(1, 3, 256, 256), kernel_size: int = 61,
                intensity: float = 3.0, sigma_s: float = 0.05,
                kernel: Optional[np.ndarray] = None,
                kernel_path: Optional[str] = None, seed: Optional[int] = None,
                device="cuda", **_):
    if kernel is None:
        if kernel_path is not None:
            kernel = okernels.load_kernel_npy(kernel_path)
        elif name == "gaussian_blur":
            kernel = okernels.gaussian_kernel(kernel_size, intensity)
        else:
            kernel = okernels.motion_blur_kernel(kernel_size, intensity,
                                                 seed=seed)
    return BlurOperator(float(np.float32(sigma_s)), kernel,
                        _nchw_shape_to_hw(in_shape), device, name)


@register_operator("gaussian_blur")
def _build_gaussian_blur(**kw):
    return _build_blur("gaussian_blur", **kw)


@register_operator("motion_blur")
def _build_motion_blur(**kw):
    kw.setdefault("intensity", 0.5)
    return _build_blur("motion_blur", **kw)


class SuperResolutionOperator(_FFTKernel):
    """A = the exact antialiased bicubic downsample (ResizeRight), with the
    FFT kernel form (blur, then keep every sf-th pixel) for the transpose
    and the likelihood solve (ref: measurements.py:86-122). The transpose
    is the adjoint of the FFT form, not of the bicubic forward, as in the
    reference (measurements.py:113-119)."""
    name = "super_resolution"

    def __init__(self, sigma_s, kernel, hw, scale_factor: int, device):
        super().__init__(sigma_s, kernel, hw, device)
        self.scale_factor = scale_factor
        _, (self.Mh, self.Mw) = oresize.make_resizer(hw, 1.0 / scale_factor,
                                                     device=device)

    def forward(self, x):
        return oresize.apply_resize(x, self.Mh, self.Mw)

    def transpose(self, y):
        return offt.ifft2(self.FBC * offt.fft2(
            offt.upsample(y, self.scale_factor))).real


@register_operator("super_resolution")
def _build_super_resolution(in_shape=(1, 3, 256, 256), scale_factor: int = 4,
                            sigma_s: float = 0.05,
                            kernel: Optional[np.ndarray] = None,
                            kernel_path: Optional[str] = None, device="cuda",
                            **_):
    sf = int(scale_factor)
    if kernel is None:
        if kernel_path is not None:
            kernel = okernels.load_bicubic_mat(kernel_path, sf)
        else:
            kernel = okernels.bicubic_kernel(sf)
    return SuperResolutionOperator(float(np.float32(sigma_s)), kernel,
                                   _nchw_shape_to_hw(in_shape), sf, device)


class InpaintingOperator(LinearOperator):
    """A = fixed masking (ref: measurements.py:202-244). The measurement
    keeps image layout: y = mask * (x + n)."""
    name = "inpainting"

    def __init__(self, mask: torch.Tensor, sigma_s: float):
        super().__init__(sigma_s)
        self.mask = mask  # [1, C, H, W] in {0, 1}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.mask

    def transpose(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.mask

    def measure(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Measurement:
        """Noise is added before masking, like measurements.py:211-219. Pass
        `noise` (standard normal, x's shape) to inject it, or a generator."""
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
        return Measurement(y=(x + self.sigma_s * noise) * self.mask)


@register_operator("inpainting")
def _build_inpainting(sigma_s: float = 0.05, mask_opt: Optional[dict] = None,
                      mask: Optional[np.ndarray] = None,
                      seed: Optional[int] = None, device="cuda", **_):
    if mask is None:
        mask = generate_mask(seed=seed, **(mask_opt or {}))
    # contiguous NCHW: elementwise results take the layout of their inputs,
    # and the DWT kernel takes contiguous tensors only
    mask = torch.from_numpy(np.ascontiguousarray(
        np.asarray(mask, np.float32).transpose(2, 0, 1)[None])).to(device)
    return InpaintingOperator(mask=mask, sigma_s=float(np.float32(sigma_s)))


# ---------------------------------------------------------------------------
# Nonlinear operators (ref: measurements.py:322-367)
# ---------------------------------------------------------------------------

def _gaussian_measure(forward, sigma_s, x, noise, generator, **kw):
    y = forward(x, **kw)
    if noise is None:
        noise = torch.randn(y.shape, generator=generator, device=y.device,
                            dtype=y.dtype)
    return Measurement(y=y + sigma_s * noise)


class PhaseRetrievalOperator:
    """y = |F(pad(x))|, the centred 2-D FFT magnitude of the zero-padded
    image over H and W (ref: measurements.py:330-339, dps_utils
    img_utils.py:26 fft2_m; `kdip_tpu` operators.py:361-384), on
    torch.fft; differentiable. It has no mat solver: only dps, stsl and
    uncond guidance reach it."""
    name = "phase_retrieval"

    def __init__(self, pad: int = 32, sigma_s: float = 0.05):
        self.pad = pad
        self.sigma_s = sigma_s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad
        xp = torch.nn.functional.pad(x, (p, p, p, p))
        dims = (-2, -1)
        f = torch.fft.fftshift(torch.fft.fftn(
            torch.fft.ifftshift(xp, dim=dims), dim=dims), dim=dims)
        return f.abs()

    def project(self, x, measurement):
        return x + measurement - self.forward(x)

    def measure(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Measurement:
        """y = forward(x) + sigma_s * n, n injected (standard normal, y's
        shape) or drawn from `generator`."""
        return _gaussian_measure(self.forward, self.sigma_s, x, noise,
                                 generator)


@register_operator("phase_retrieval")
def _build_phase_retrieval(oversample: float = 1.0, sigma_s: float = 0.05,
                           **_):
    # the reference's pad: oversample / 8 of 256, whatever the image size
    return PhaseRetrievalOperator(pad=int((oversample / 8.0) * 256),
                                  sigma_s=float(np.float32(sigma_s)))


class NonlinearBlurOperator:
    """A learned nonlinear blur (ref: measurements.py:341-367; `kdip_tpu`
    operators.py:393-430): `blur_apply(x01, kernel) -> x01`, any
    differentiable callable over [0, 1]-scaled NCHW images (the reference
    loads the external bkse KernelWizard), with the [-1, 1] <-> [0, 1]
    rescaling and the clip. forward uses the operator's `kernel` (as
    `kdip_tpu`'s forward without a key uses one fixed draw); measure
    draws a fresh N(0, 1.2^2) kernel of kernel_shape unless one is
    injected, as the reference does."""
    name = "nonlinear_blur"

    def __init__(self, blur_apply: Callable, kernel: torch.Tensor,
                 sigma_s: float = 0.05):
        self.blur_apply = blur_apply
        self.kernel = kernel
        self.kernel_shape = tuple(kernel.shape)
        self.sigma_s = sigma_s

    def draw_kernel(self, generator: Optional[torch.Generator] = None):
        """A N(0, 1.2^2) kernel of kernel_shape from `generator`."""
        return torch.randn(self.kernel_shape, generator=generator,
                           device=self.kernel.device) * 1.2

    def forward(self, x: torch.Tensor,
                kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
        kernel = self.kernel if kernel is None else kernel
        blurred = self.blur_apply((x + 1.0) / 2.0, kernel)
        return (blurred * 2.0 - 1.0).clamp(-1, 1)

    def project(self, x, measurement):
        return x + measurement - self.forward(x)

    def measure(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                kernel: Optional[torch.Tensor] = None) -> Measurement:
        """y = forward(x, kernel) + sigma_s * n: the kernel and n injected,
        or drawn from `generator` (kernel first)."""
        if kernel is None:
            kernel = self.draw_kernel(generator)
        return _gaussian_measure(self.forward, self.sigma_s, x, noise,
                                 generator, kernel=kernel)


@register_operator("nonlinear_blur")
def _build_nonlinear_blur(blur_apply: Optional[Callable] = None,
                          kernel_shape=(1, 512, 2, 2), sigma_s: float = 0.05,
                          kernel: Optional[torch.Tensor] = None,
                          seed: Optional[int] = None, device="cuda", **_):
    """kernel_shape defaults to the KernelWizard's (1, 512, 2, 2), NCHW
    (`kdip_tpu`'s (1, 2, 2, 512) is NHWC). forward's kernel is `kernel`,
    else a N(0, 1.2^2) draw from a generator seeded with `seed` (0 if
    None)."""
    if blur_apply is None:
        raise ValueError("nonlinear_blur needs a blur network callable (the "
                         "reference loads the external bkse KernelWizard; "
                         "pass its apply function as blur_apply)")
    if kernel is None:
        g = torch.Generator(device=device).manual_seed(
            0 if seed is None else seed)
        kernel = torch.randn(tuple(kernel_shape), generator=g,
                             device=device) * 1.2
    return NonlinearBlurOperator(blur_apply, kernel.to(device),
                                 float(np.float32(sigma_s)))


def generate_mask(mask_type: str = "random", mask_len_range=None,
                  mask_prob_range=None, image_size: int = 256, margin=(16, 16),
                  num_channels: int = 3, seed: Optional[int] = None) -> np.ndarray:
    """Inpainting mask synthesis, host-side numpy, [H, W, C]; bit-exact with
    `kdip_tpu.operators.generate_mask` (ref: measurements.py:247-319)."""
    rng = np.random.RandomState(seed)
    if mask_type not in ("box", "random", "both", "extreme"):
        raise ValueError(f"unknown mask_type {mask_type!r}")
    if mask_type == "random":
        l, h = mask_prob_range
        prob = rng.uniform(l, h)
        total = image_size ** 2
        mask_vec = np.ones(total, dtype=np.float32)
        samples = rng.choice(total, int(total * prob), replace=False)
        mask_vec[samples] = 0
        mask = mask_vec.reshape(image_size, image_size)[..., None]
        return np.repeat(mask, num_channels, axis=-1)
    # box / extreme: centered square box (measurements.py:310-313)
    l, h = (int(mask_len_range[0]), int(mask_len_range[1]))
    mask_h = rng.randint(l, h)
    mask_w = rng.randint(l, h)
    margin_height, margin_width = margin
    maxt = image_size - margin_height - mask_h
    maxl = image_size - margin_width - mask_w
    t = (margin_height + maxt) // 2
    lft = (margin_width + maxl) // 2
    mask = np.ones((image_size, image_size, num_channels), dtype=np.float32)
    mask[t:t + mask_h, lft:lft + mask_w, :] = 0
    if mask_type == "extreme":
        mask = 1.0 - mask
    return mask


# ---------------------------------------------------------------------------
# Noise models (ref: measurements.py:374-457)
# ---------------------------------------------------------------------------

__NOISE__: Dict[str, Callable] = {}


def register_noise(name: str):
    def wrapper(fn):
        __NOISE__[name] = fn
        return fn
    return wrapper


def get_noise(name: str, **kwargs):
    if name not in __NOISE__:
        raise NameError(f"no noise model registered under {name!r}")
    fn = __NOISE__[name]
    out = lambda data, noise=None, generator=None: fn(
        data, noise=noise, generator=generator, **kwargs)
    out.__name__ = name
    return out


@register_noise("clean")
def clean_noise(data, noise=None, generator=None):
    return data


@register_noise("gaussian")
def gaussian_noise(data, noise=None, generator=None, sigma: float = 0.05):
    """data + sigma * n, with n injected or drawn from `generator`."""
    if noise is None:
        noise = torch.randn(data.shape, generator=generator,
                            device=data.device, dtype=data.dtype)
    return data + sigma * noise


@register_noise("poisson")
def poisson_noise(data, noise=None, generator=None, rate: float = 1.0):
    """Poisson shot noise on [0, 255]-scaled intensities (ref:
    measurements.py:413-434, "version 3"; `kdip_tpu` operators.py:474-481):
    counts ~ Poisson(clip((data + 1) / 2, 0, 1) * 255 * rate), then
    clip(counts / 255 / rate * 2 - 1, -1, 1). For this model `noise` is
    the counts, injected, else drawn by torch.poisson from `generator`."""
    lam = ((data + 1.0) / 2.0).clamp(0, 1) * 255.0 * rate
    counts = (torch.poisson(lam, generator=generator) if noise is None
              else noise)
    noisy = counts.to(data.dtype) / 255.0 / rate
    return (noisy * 2.0 - 1.0).clamp(-1, 1)
