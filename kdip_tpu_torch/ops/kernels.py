"""Degradation kernels: generation and loading (port of
`kdip_tpu/ops/kernels.py`; numpy, host-side).

- the gaussian blur PSF, scipy.ndimage.gaussian_filter on a delta (ref:
  dps_utils/img_utils.py:278-283);
- the antialiased bicubic SR PSF;
- the random-walk motion-blur PSF (ref: motionblur/motionblur.py:52-419),
  which rasterises its path with PIL. PIL is imported only when a motion
  kernel is drawn: where it is missing, pass the operator a `kernel=` or a
  `kernel_path=` (the package ships `data/motion_ks61_i0.5_seed0.npy`);
- loaders for pinned .npy / .mat kernels (ref: condition/measurements.py:95,
  134, 173) and for the Levin09 kernels (an HDF5 file, read with h5py);
- MATLAB's fspecial zoo and the camera-shake trajectory PSF
  (ref: condition/diffpir_utils/utils_deblur.py:461-632), the same numpy
  and RandomState draws as `kdip_tpu`, so a seed gives the same kernel
  bit for bit.
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


# ---------------------------------------------------------------------------
# MATLAB-style fspecial kernel zoo
# (ref: condition/diffpir_utils/utils_deblur.py:461-547)
# ---------------------------------------------------------------------------

def fspecial_average(hsize: int = 3) -> np.ndarray:
    """Uniform averaging kernel (ref: utils_deblur.py:461-463)."""
    return np.ones((hsize, hsize)) / (hsize * hsize)


def fspecial_disk(radius: int) -> np.ndarray:
    """Pillbox (disk) kernel via subpixel coverage approximation
    (ref: utils_deblur.py:466-485)."""
    rad = 0.6
    crad = int(np.ceil(rad - 0.5))
    y, x = np.mgrid[-crad:crad + 1, -crad:crad + 1].astype(float)
    maxxy = np.maximum(np.abs(x), np.abs(y))
    minxy = np.minimum(np.abs(x), np.abs(y))
    with np.errstate(invalid="ignore"):
        m1 = ((rad ** 2 < (maxxy + 0.5) ** 2 + (minxy - 0.5) ** 2)
              * (minxy - 0.5)
              + np.nan_to_num((rad ** 2 >= (maxxy + 0.5) ** 2 + (minxy - 0.5) ** 2)
                              * np.sqrt(np.maximum(rad ** 2 - (maxxy + 0.5) ** 2, 0))))
        m2 = ((rad ** 2 > (maxxy - 0.5) ** 2 + (minxy + 0.5) ** 2)
              * (minxy + 0.5)
              + np.nan_to_num((rad ** 2 <= (maxxy - 0.5) ** 2 + (minxy + 0.5) ** 2)
                              * np.sqrt(np.maximum(rad ** 2 - (maxxy - 0.5) ** 2, 0))))
    sgrid = ((rad ** 2 * (0.5 * (np.arcsin(np.clip(m2 / rad, -1, 1))
                                 - np.arcsin(np.clip(m1 / rad, -1, 1)))
                          + 0.25 * (np.sin(2 * np.arcsin(np.clip(m2 / rad, -1, 1)))
                                    - np.sin(2 * np.arcsin(np.clip(m1 / rad, -1, 1)))))
              - (maxxy - 0.5) * (m2 - m1) + (m1 - minxy + 0.5))
             * (((rad ** 2 < (maxxy + 0.5) ** 2 + (minxy + 0.5) ** 2)
                 & (rad ** 2 > (maxxy - 0.5) ** 2 + (minxy - 0.5) ** 2))
                | ((minxy == 0) & (maxxy - 0.5 < rad) & (maxxy + 0.5 >= rad))))
    sgrid = sgrid + ((maxxy + 0.5) ** 2 + (minxy + 0.5) ** 2 < rad ** 2)
    sgrid[crad, crad] = min(np.pi * rad ** 2, np.pi / 2)
    if crad > 0 and rad > crad - 0.5 and rad ** 2 < (crad - 0.5) ** 2 + 0.25:
        m1v = np.sqrt(rad ** 2 - (crad - 0.5) ** 2)
        m1n = m1v / rad
        sg0 = 2 * (rad ** 2 * (0.5 * np.arcsin(m1n) + 0.25 * np.sin(2 * np.arcsin(m1n)))
                   - m1v * (crad - 0.5))
        sgrid[2 * crad, crad] = sg0
        sgrid[crad, 2 * crad] = sg0
        sgrid[crad, 0] = sg0
        sgrid[0, crad] = sg0
        sgrid[2 * crad - 1, crad] -= sg0
        sgrid[crad, 2 * crad - 1] -= sg0
        sgrid[crad, 1] -= sg0
        sgrid[1, crad] -= sg0
    sgrid[crad, crad] = min(sgrid[crad, crad], 1)
    return sgrid / sgrid.sum()


def fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    """Truncated analytic Gaussian, MATLAB convention
    (ref: utils_deblur.py:488-499)."""
    siz = [(hsize - 1.0) / 2.0] * 2
    std = sigma
    y, x = np.mgrid[-siz[0]:siz[0] + 1, -siz[1]:siz[1] + 1]
    arg = -(x * x + y * y) / (2 * std * std)
    h = np.exp(arg)
    h[h < np.finfo(float).eps * h.max()] = 0
    sumh = h.sum()
    if sumh != 0:
        h = h / sumh
    return h


def fspecial_laplacian(alpha: float) -> np.ndarray:
    """(ref: utils_deblur.py:502-508)"""
    alpha = max(0, min(alpha, 1))
    h1 = alpha / (alpha + 1)
    h2 = (1 - alpha) / (alpha + 1)
    return np.array([[h1, h2, h1], [h2, -4 / (alpha + 1), h2], [h1, h2, h1]])


def fspecial_log(hsize: int, sigma: float) -> np.ndarray:
    """Laplacian of Gaussian (ref: utils_deblur.py:511-512 via MATLAB conv)."""
    siz = (hsize - 1) / 2
    std2 = sigma ** 2
    y, x = np.mgrid[-siz:siz + 1, -siz:siz + 1]
    arg = -(x * x + y * y) / (2 * std2)
    h = np.exp(arg)
    h[h < np.finfo(float).eps * h.max()] = 0
    h = h / h.sum() if h.sum() != 0 else h
    h1 = h * (x * x + y * y - 2 * std2) / (std2 ** 2)
    return h1 - h1.sum() / (hsize * hsize)


def fspecial_motion(motion_len: float, theta: float) -> np.ndarray:
    """MATLAB fspecial('motion', len, theta): a line segment of length
    `motion_len` at angle `theta` (degrees, CCW), antialiased.

    The reference stubs this out with NotImplemented
    (ref: utils_deblur.py:515-516); we implement the MATLAB algorithm
    (perpendicular-distance antialiasing over a half-line, mirrored)."""
    length = max(1.0, float(motion_len))
    half = (length - 1) / 2.0
    phi = np.deg2rad(theta % 180.0)
    cosphi, sinphi = np.cos(phi), np.sin(phi)
    xsign = np.sign(cosphi) if cosphi != 0 else 1.0
    linewdt = 1.0
    # half-size of the kernel
    eps = np.finfo(float).eps
    sx = int(np.fix(half * cosphi + linewdt * xsign - length * eps))
    sy = int(np.fix(half * sinphi + linewdt - length * eps))
    x, y = np.meshgrid(np.arange(0, sx + xsign, xsign or 1),
                       np.arange(0, sy + 1))
    # distance from each pixel to the line through the origin
    dist2line = y * cosphi - x * sinphi
    rad = np.sqrt(x ** 2 + y ** 2)
    # pixels past the segment endpoint: measure to the endpoint instead
    lastpix = (rad >= half) & (np.abs(dist2line) <= linewdt)
    x2lastpix = half - np.abs((x[lastpix] + dist2line[lastpix] * sinphi)
                              / cosphi) if cosphi != 0 else half - y[lastpix]
    dist2line = dist2line.copy()
    dist2line[lastpix] = np.sqrt(dist2line[lastpix] ** 2 + x2lastpix ** 2)
    dist2line = linewdt + eps - np.abs(dist2line)
    dist2line[dist2line < 0] = 0
    # mirror to the full kernel
    h = np.rot90(dist2line, 2)
    H = np.zeros((h.shape[0] * 2 - 1, h.shape[1] * 2 - 1))
    H[:h.shape[0], :h.shape[1]] = h
    H[h.shape[0] - 1:, h.shape[1] - 1:] = dist2line
    H = H / (H.sum() + eps * length * length)
    if cosphi > 0:
        H = np.flipud(H)
    return H


def fspecial_prewitt() -> np.ndarray:
    """(ref: utils_deblur.py:519-520)"""
    return np.array([[1, 1, 1], [0, 0, 0], [-1, -1, -1]], dtype=np.float64)


def fspecial_sobel() -> np.ndarray:
    """(ref: utils_deblur.py:523-524)"""
    return np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=np.float64)


def fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    """MATLAB-meshgrid Gaussian used by the trajectory blur synthesizer
    (ref: utils_deblur.py:550-553); note the off-center grid for even
    sizes matches the reference's `mgrid[-size//2+1 : size//2+1]`."""
    ax = np.arange(-size // 2 + 1, size // 2 + 1)
    x, y = np.meshgrid(ax, ax, indexing="ij")
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def fspecial(filter_type: str, *args, **kwargs) -> np.ndarray:
    """MATLAB fspecial dispatch (ref: utils_deblur.py:527-541)."""
    if filter_type == "average":
        return fspecial_average(*args, **kwargs)
    if filter_type == "disk":
        return fspecial_disk(*args, **kwargs)
    if filter_type == "gaussian":
        return fspecial_gaussian(*args, **kwargs)
    if filter_type == "laplacian":
        return fspecial_laplacian(*args, **kwargs)
    if filter_type == "log":
        return fspecial_log(*args, **kwargs)
    if filter_type == "motion":
        return fspecial_motion(*args, **kwargs)
    if filter_type == "prewitt":
        return fspecial_prewitt(*args, **kwargs)
    if filter_type == "sobel":
        return fspecial_sobel(*args, **kwargs)
    raise ValueError(f"unknown fspecial filter: {filter_type}")


# ---------------------------------------------------------------------------
# Camera-shake trajectory blur synthesis (ref: utils_deblur.py:556-632)
# ---------------------------------------------------------------------------

def rot3d(x: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Rotate a 3-vector by Euler angles r = (rx, ry, rz)
    (ref: utils_deblur.py:626-632)."""
    cx, sx = np.cos(r[0]), np.sin(r[0])
    cy, sy = np.cos(r[1]), np.sin(r[1])
    cz, sz = np.cos(r[2]), np.sin(r[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx @ x


def random_trajectory(rng: np.random.RandomState, T: int = 150) -> np.ndarray:
    """3-D camera-shake trajectory: random rotational + translational forces
    integrated over T steps (ref: utils_deblur.py:609-623). Draw order
    matches the reference so a shared seed is bit-reproducible."""
    x = np.zeros((3, T))
    v = rng.randn(3, T)
    r = np.zeros((3, T))
    trv, trr = 1.0, 2.0 * np.pi / T
    for t in range(1, T):
        f_rot = rng.randn(3) / (t + 1) + r[:, t - 1]
        f_trans = rng.randn(3) / (t + 1)
        r[:, t] = r[:, t - 1] + trr * f_rot
        v[:, t] = v[:, t - 1] + trv * f_trans
        x[:, t] = x[:, t - 1] + rot3d(v[:, t], r[:, t])
    return x


def kernel_from_trajectory(rng: np.random.RandomState,
                           x: np.ndarray) -> Optional[np.ndarray]:
    """Histogram the 2-D projection of a trajectory into a PSF of random odd
    size h in [5, 27], Gaussian-soften (ref: utils_deblur.py:578-606).
    Returns None when the trajectory spans fewer than 2 bins (reference
    returns an implicit None and the caller retries)."""
    h = 5 - np.log(rng.rand()) / 0.15
    h = int(round(min(h, 27)))
    h = h + 1 - h % 2
    w = h
    k = np.zeros((h, w))
    xmin, xmax = x[0].min(), x[0].max()
    ymin, ymax = x[1].min(), x[1].max()
    xthr = np.arange(xmin, xmax, (xmax - xmin) / w)
    ythr = np.arange(ymin, ymax, (ymax - ymin) / h)
    for i in range(1, xthr.size):
        for j in range(1, ythr.size):
            idx = ((x[0, :] >= xthr[i - 1]) & (x[0, :] < xthr[i])
                   & (x[1, :] >= ythr[j - 1]) & (x[1, :] < ythr[j]))
            k[i - 1, j - 1] = idx.sum()
    if k.sum() == 0:
        return None
    k = k / k.sum()
    from scipy.signal import convolve2d
    k = convolve2d(k, fspecial_gauss(3, 1), "same")
    return k / k.sum()


def blurkernel_synthesis(h: int = 37, w: Optional[int] = None,
                         seed: Optional[int] = None,
                         rng: Optional[np.random.RandomState] = None
                         ) -> np.ndarray:
    """Random camera-shake PSF, center-padded/cropped to (h, w)
    (ref: utils_deblur.py:556-575). Explicit RNG instead of numpy's global
    state; pass `rng` already-seeded to reproduce a reference draw."""
    if rng is None:
        rng = np.random.RandomState(seed)
    w = h if w is None else w
    x = random_trajectory(rng, 150)
    k = None
    while k is None:
        k = kernel_from_trajectory(rng, x)
    ph = (h - k.shape[0]) // 2
    pw = (w - k.shape[1]) // 2
    if ph < 0 or pw < 0:
        k = k[:h, :h]
    else:
        k = np.pad(k, ((ph, ph), (pw, pw)), "constant")
    return k


def load_levin_kernels(path: str) -> list:
    """Loads the 8 Levin09 deblur kernels (ref: the Levin09.mat data shipped
    in condition/kernels, used by the DiffPIR kernel zoo). The file is a
    MATLAB v7.3 (HDF5) container of object references."""
    import h5py
    with h5py.File(path, "r") as f:
        refs = f["kernels"]
        out = []
        for i in range(refs.shape[0]):
            for j in range(refs.shape[1]):
                k = np.asarray(f[refs[i, j]], dtype=np.float64).T
                out.append(k / k.sum())
        return out
