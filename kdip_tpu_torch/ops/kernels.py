"""Degradation kernels: generation and loading (port of
`kdip_tpu/ops/kernels.py:24-132, 401-415`; numpy, host-side).

- the gaussian blur PSF, scipy.ndimage.gaussian_filter on a delta (ref:
  dps_utils/img_utils.py:278-283);
- the antialiased bicubic SR PSF;
- the random-walk motion-blur PSF (ref: motionblur/motionblur.py:52-419),
  which rasterises its path with PIL. PIL is imported only when a motion
  kernel is drawn: where it is missing, pass the operator a `kernel=` or a
  `kernel_path=` (the package ships `data/motion_ks61_i0.5_seed0.npy`);
- loaders for pinned .npy / .mat kernels (ref: condition/measurements.py:95,
  134, 173).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .resize import cubic


def gaussian_kernel(kernel_size: int = 61, std: float = 3.0) -> np.ndarray:
    """Truncated discrete Gaussian PSF summing to 1:
    scipy.ndimage.gaussian_filter(delta, sigma=std) (radius 4*std), as the
    reference builds its gaussian kernels."""
    from scipy import ndimage
    n = np.zeros((kernel_size, kernel_size))
    n[kernel_size // 2, kernel_size // 2] = 1
    return ndimage.gaussian_filter(n, sigma=std)


def bicubic_kernel(scale_factor: int) -> np.ndarray:
    """Antialiased bicubic downsampling PSF for an integer scale factor: the
    separable `sf * cubic(sf * x)` on the integer grid, (4 sf + 1)^2."""
    size = 4 * scale_factor + 1
    ax = np.arange(size) - size // 2
    k1 = cubic(ax / scale_factor) / scale_factor
    k = np.outer(k1, k1)
    return (k / k.sum()).astype(np.float64)


_MOTION_EPS = 0.1  # numerical-stability epsilon (ref: motionblur.py:9)


def motion_blur_kernel(kernel_size: int = 61, intensity: float = 0.5,
                       seed: Optional[int] = None) -> np.ndarray:
    """Stochastic motion-blur PSF (ref: motionblur/motionblur.py:52-419),
    per seed bit-identical to `kdip_tpu.ops.kernels.motion_blur_kernel`: a
    random path of beta-distributed steps and triangular-jittered headings,
    centred on its mean and rotated, drawn at 2x with an antialiased line,
    softened by a gaussian and LANCZOS-downscaled. intensity in [0, 1]: 0 is
    near-linear motion, 1 a highly non-linear path. Needs PIL."""
    try:
        from PIL import Image, ImageDraw, ImageFilter
    except ImportError as e:
        raise ImportError(
            "motion_blur_kernel rasterises with PIL, which is not installed: "
            "pass the operator kernel= or kernel_path= (e.g. the packaged "
            "kdip_tpu_torch/data/motion_ks61_i0.5_seed0.npy)") from e
    rng = np.random.RandomState(seed)
    intensity = float(intensity)
    if not 0 <= intensity <= 1:
        raise ValueError(f"intensity must be in [0, 1], got {intensity}")
    size = (int(kernel_size), int(kernel_size))
    # supersample 2x for anti-aliasing, downscale at the end (ref :99-106)
    x2, y2 = 2 * size[0], 2 * size[1]
    diagonal = (x2 ** 2 + y2 ** 2) ** 0.5

    # step lengths (ref _createPath/getSteps, :123-157)
    max_path_len = 0.75 * diagonal * (rng.uniform()
                                      + rng.uniform(0, intensity ** 2))
    steps = []
    while sum(steps) < max_path_len:
        step = rng.beta(1, 30) * (1 - intensity + _MOTION_EPS) * diagonal
        if step < max_path_len:
            steps.append(step)
    num_steps = len(steps)

    # headings (ref getAngles, :159-197)
    max_angle = rng.uniform(0, intensity * math.pi)
    jitter = rng.beta(2, 20)
    angles = [rng.uniform(low=-max_angle, high=max_angle)]
    while len(angles) < num_steps:
        angle = rng.triangular(0, intensity * max_angle,
                               max_angle + _MOTION_EPS)
        angle *= -np.sign(angles[-1]) if rng.uniform() < jitter \
            else np.sign(angles[-1])
        angles.append(angle)

    # path: cumsum of polar increments, centred, randomly rotated (:203-230)
    increments = np.asarray(steps) * np.exp(1j * np.asarray(angles))
    path = np.cumsum(increments)
    path = path - path.sum() / num_steps
    path = path * np.exp(1j * rng.uniform(0, math.pi))
    path = path + (x2 + 1j * y2) / 2
    points = [(p.real, p.imag) for p in path]

    # rasterise (ref _createKernel, :232-271)
    img = Image.new("RGB", (x2, y2))
    ImageDraw.Draw(img).line(xy=points, width=int(diagonal / 150))
    img = img.filter(ImageFilter.GaussianBlur(radius=int(diagonal * 0.01)))
    img = img.resize(size, resample=Image.LANCZOS).convert("L")
    kernel = np.asarray(img, dtype=np.float32)
    total = kernel.sum()
    if total <= 0:  # degenerate draw (a zero-length path): a delta kernel
        kernel = np.zeros(size, np.float32)
        kernel[size[1] // 2, size[0] // 2] = 1.0
        return kernel
    return kernel / total


def load_kernel_npy(path: str) -> np.ndarray:
    """A pinned .npy degradation kernel, float64."""
    return np.load(path).astype(np.float64)


def load_bicubic_mat(path: str, scale_factor: int) -> np.ndarray:
    """The pinned bicubic kernel of kernels_bicubicx234.mat: index sf - 2 for
    sf in {2, 3, 4} (ref: condition/measurements.py:95-97)."""
    from scipy import io as sio
    kernels = sio.loadmat(path)["kernels"]
    k_index = scale_factor - 2 if scale_factor < 5 else 2
    return kernels[0, k_index].astype(np.float64)
