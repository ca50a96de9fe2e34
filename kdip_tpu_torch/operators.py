"""Measurement operators y = A x + n (PyTorch port of `kdip_tpu/operators.py`;
ref: condition/measurements.py). NCHW images in [-1, 1].

This slice ports random/box inpainting and the gaussian noise model; the
other registered operators raise NotImplementedError until their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch


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


def _later_slice(name: str):
    def build(**_):
        raise NotImplementedError(
            f"operator {name!r} is not ported yet: a later slice of the "
            "PyTorch port (ROADMAP queue 1, item 3)")
    register_operator(name)(build)


for _name in ("noise", "colorization", "gaussian_blur", "motion_blur",
              "super_resolution", "phase_retrieval", "nonlinear_blur"):
    _later_slice(_name)


class InpaintingOperator:
    """A = fixed masking (ref: measurements.py:202-244). The measurement
    keeps image layout: y = mask * (x + n)."""
    name = "inpainting"

    def __init__(self, mask: torch.Tensor, sigma_s: float):
        self.mask = mask  # [1, C, H, W] in {0, 1}
        self.sigma_s = sigma_s

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
