"""MATLAB-compatible image utilities (port of `kdip_tpu/ops/image_utils.py`;
ref: condition/diffpir_utils/utils_image.py):

- MATLAB `imresize` (ref: utils_image.py:621-774) as dense per-axis resize
  matrices (`imresize_matrix`, numpy float64, the symmetric boundary
  folded into the columns): on a tensor, two matrix products on its
  device in its dtype; on a numpy HWC array, two float64 einsums;
- MATLAB PSNR and SSIM (ref: utils_image.py:546-610) in float64 numpy,
  as reported metrics;
- dtype and YCbCr conversions, `modcrop` / `shave`, the dihedral augment
  family and the numpy <-> tensor converters, the tensors NCHW / CHW as
  the reference's torch ones;
- `imread_uint` / `imsave` without PIL for 8-bit PNGs (`data.read_png`,
  `data.write_png`); other files (JPEGs) through PIL.

As in `kdip_tpu`, the two matplotlib display helpers (`imshow`, `surf`)
are left out.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

__all__ = [
    "uint2single", "single2uint", "uint162single", "single2uint16",
    "rgb2ycbcr", "ycbcr2rgb", "bgr2ycbcr", "modcrop", "shave",
    "imresize_matrix", "imresize", "imresize_np",
    "calculate_psnr", "calculate_ssim",
    "imread_uint", "imsave",
    "IMG_EXTENSIONS", "is_image_file", "get_timestamp", "get_image_paths",
    "mkdir", "mkdirs", "mkdir_and_rename", "todevice", "read_img",
    "uint2tensor4", "uint2tensor3", "tensor2uint",
    "single2tensor4", "single2tensor5", "single32tensor5", "single42tensor4",
    "single2tensor3", "single2tensor2", "tensor2single", "tensor2single3",
    "tensor2img",
    "augment_img", "augment_img_tensor4", "augment_img_np3",
    "augment_img_tensor", "augment_imgs", "channel_convert",
]


# ---------------------------------------------------------------------------
# dtype conversions (ref: utils_image.py:182-205)
# ---------------------------------------------------------------------------

def uint2single(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1] (ref: utils_image.py:182-184)."""
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, clipped+rounded (ref: utils_image.py:187-189)."""
    return np.uint8((np.clip(img, 0.0, 1.0) * 255.0).round())


def uint162single(img: np.ndarray) -> np.ndarray:
    """uint16 [0,65535] -> float32 [0,1] (ref: utils_image.py:192-194)."""
    return np.float32(img / 65535.0)


def single2uint16(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint16 (ref: utils_image.py:197-199)."""
    return np.uint16((np.clip(img, 0.0, 1.0) * 65535.0).round())


# ---------------------------------------------------------------------------
# color space (MATLAB-coefficient YCbCr; ref: utils_image.py:429-495)
# ---------------------------------------------------------------------------

_RGB2YCBCR = np.array([[65.481, -37.797, 112.0],
                       [128.553, -74.203, -93.786],
                       [24.966, 112.0, -18.214]], dtype=np.float64)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def _ycbcr_common(img: np.ndarray, mat: np.ndarray, offset) -> np.ndarray:
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    out = x @ mat + offset
    if in_type == np.uint8:
        out = out.round()
    else:
        out = out / 255.0
    return out.astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr; uint8 [0,255] or float [0,1]
    (ref: utils_image.py:429-450)."""
    if only_y:
        return _ycbcr_common(img, _RGB2YCBCR[:, :1] / 255.0,
                             np.array([16.0]))[..., 0]
    return _ycbcr_common(img, _RGB2YCBCR / 255.0, _YCBCR_OFFSET)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR variant (ref: utils_image.py:474-495)."""
    mat = _RGB2YCBCR[::-1]
    if only_y:
        return _ycbcr_common(img, mat[:, :1] / 255.0, np.array([16.0]))[..., 0]
    return _ycbcr_common(img, mat / 255.0, _YCBCR_OFFSET)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB ycbcr2rgb (ref: utils_image.py:453-471)."""
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    mat = np.array([[0.00456621, 0.00456621, 0.00456621],
                    [0.0, -0.00153632, 0.00791071],
                    [0.00625893, -0.00318811, 0.0]], dtype=np.float64)
    out = x @ mat * 255.0 + np.array([-222.921, 135.576, -276.836])
    out = np.clip(out, 0.0, 255.0)
    if in_type == np.uint8:
        out = out.round()
    else:
        out = out / 255.0
    return out.astype(in_type)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H,W to multiples of scale (ref: utils_image.py:498-511)."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale]


def shave(img: np.ndarray, border: int = 0) -> np.ndarray:
    """Trim a border (ref: utils_image.py:514-519)."""
    if border == 0:
        return img
    return img[border:-border, border:-border]


# ---------------------------------------------------------------------------
# MATLAB imresize, bicubic with antialiasing (ref: utils_image.py:621-774)
# ---------------------------------------------------------------------------

def _matlab_cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1.0)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0)
            * ((ax > 1.0) & (ax <= 2.0)))


def imresize_matrix(in_length: int, scale: float,
                    antialiasing: bool = True) -> np.ndarray:
    """Dense (out_length, in_length) MATLAB-bicubic resize matrix.

    Matches the reference's calculate_weights_indices + symmetric boundary
    copy (ref: utils_image.py:629-754) exactly, but expressed as one matrix
    so the resize itself is a single (MXU) matmul per axis. Out-of-range
    taps are reflected (single symmetric reflection) into valid columns.
    """
    out_length = int(math.ceil(in_length * scale))
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    p = int(math.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _matlab_cubic(dist * scale)
    else:
        weights = _matlab_cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # Drop an all-zero first/last column (ref: utils_image.py:668-675).
    zero_cols = (weights == 0).sum(axis=0)
    col0, col1 = 0, p
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        col0 += 1
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        col1 -= 1
    weights = weights[:, col0:col1]
    indices = indices[:, col0:col1].astype(np.int64) - 1  # 0-based

    # Fold the symmetric boundary extension into the matrix columns.
    # Iterate the reflection: for very strong downscales the kernel can be
    # wider than 2*in_length, so one reflection may land out of range again
    # (numpy's negative indexing would then silently hit a wrong column).
    mat = np.zeros((out_length, in_length), dtype=np.float64)
    idx = indices.copy()
    for _ in range(max(1, int(math.ceil(kernel_width / (2 * in_length))) + 1)):
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= in_length, 2 * in_length - 1 - idx, idx)
    assert (idx >= 0).all() and (idx < in_length).all(), \
        f"boundary reflection failed for scale={scale}, in_length={in_length}"
    rows = np.repeat(np.arange(out_length), idx.shape[1])
    np.add.at(mat, (rows, idx.ravel()), weights.ravel())
    return mat


def imresize(img, scale: float, antialiasing: bool = True):
    """MATLAB imresize (bicubic, antialiased when shrinking) of float
    images in [0, 1] (ref: utils_image.py:687-774). A numpy array is HW or
    HWC and resizes in float64; a tensor is [..., H, W] (CHW, NCHW) and
    resizes by two matrix products on its device, in its dtype, the rows
    first."""
    if torch.is_tensor(img):
        mh = torch.as_tensor(imresize_matrix(img.shape[-2], scale,
                                             antialiasing),
                             dtype=img.dtype, device=img.device)
        mw = torch.as_tensor(imresize_matrix(img.shape[-1], scale,
                                             antialiasing),
                             dtype=img.dtype, device=img.device)
        return torch.matmul(torch.matmul(mh, img), mw.T)
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    mh = imresize_matrix(x.shape[0], scale, antialiasing)
    mw = imresize_matrix(x.shape[1], scale, antialiasing)
    out = np.einsum("oh,hwc->owc", mh, x.astype(np.float64))
    out = np.einsum("pw,owc->opc", mw, out)
    return out[..., 0] if squeeze else out


def imresize_np(img: np.ndarray, scale: float,
                antialiasing: bool = True) -> np.ndarray:
    """The reference's numpy entry point (ref: utils_image.py:760)."""
    return imresize(np.asarray(img), scale, antialiasing)


# ---------------------------------------------------------------------------
# MATLAB PSNR / SSIM (ref: utils_image.py:546-610)
# ---------------------------------------------------------------------------

def calculate_psnr(img1: np.ndarray, img2: np.ndarray,
                   border: int = 0) -> float:
    """PSNR on [0,255] images with optional border crop
    (ref: utils_image.py:546-559)."""
    if img1.shape != img2.shape:
        raise ValueError("both images must share the same shape")
    a = shave(img1, border).astype(np.float64)
    b = shave(img2, border).astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * math.log10(255.0 / math.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    half = (size - 1) / 2.0
    g = np.exp(-((np.arange(size) - half) ** 2) / (2.0 * sigma * sigma))
    g = g / g.sum()
    return np.outer(g, g)


def _filter_valid(x: np.ndarray, window: np.ndarray) -> np.ndarray:
    """'same' correlation cropped to the valid region — equivalent to the
    reference's cv2.filter2D(...)[5:-5, 5:-5] (ref: utils_image.py:599-606),
    done as a separable float64 correlation."""
    k = window.shape[0]
    out_h = x.shape[0] - k + 1
    out_w = x.shape[1] - k + 1
    # Direct accumulation (k is 11; this is a reported metric, not hot).
    out = np.zeros((out_h, out_w), dtype=np.float64)
    for i in range(k):
        for j in range(k):
            out += window[i, j] * x[i:i + out_h, j:j + out_w]
    return out


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    w = _gaussian_window(11, 1.5)
    mu1 = _filter_valid(a, w)
    mu2 = _filter_valid(b, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter_valid(a * a, w) - mu1_sq
    s2 = _filter_valid(b * b, w) - mu2_sq
    s12 = _filter_valid(a * b, w) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray,
                   border: int = 0) -> float:
    """MATLAB-style SSIM on [0,255] images (ref: utils_image.py:565-610).

    NB the reference's color branch averages three calls of ssim(img1, img2)
    on the *full* array (utils_image.py:580-582) — each call already filters
    every channel, so the mean equals one whole-array evaluation; we compute
    that directly (per-channel valid-window stats, averaged)."""
    if img1.shape != img2.shape:
        raise ValueError("both images must share the same shape")
    a = shave(img1, border)
    b = shave(img2, border)
    if a.ndim == 2:
        return _ssim_single(a, b)
    if a.ndim == 3 and a.shape[2] == 1:
        return _ssim_single(a[..., 0], b[..., 0])
    if a.ndim == 3:
        return float(np.mean([_ssim_single(a[..., c], b[..., c])
                              for c in range(a.shape[2])]))
    raise ValueError("expected a 2D or 3D image array")


# ---------------------------------------------------------------------------
# IO (ref: utils_image.py:146-179)
# ---------------------------------------------------------------------------

def _pil_grey(rgb: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of uint8 RGB: (R 19595 + G 38470 + B 7471 +
    0x8000) >> 16 (Pillow Convert.c)."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def imread_uint(path: str, n_channels: int = 3) -> np.ndarray:
    """An image as uint8 [H, W, C], C = n_channels (1 or 3), as `kdip_tpu`
    reads it through PIL (ref: utils_image.py:146-158): an 8-bit PNG by
    `data.read_png`, without PIL; any other file (a JPEG) through PIL."""
    from .. import data
    if not data.decodes_natively(path):
        from PIL import Image
        with Image.open(path) as im:
            if n_channels == 1:
                return np.array(im.convert("L"))[:, :, None]
            return np.array(im.convert("RGB"))
    img = data.read_png(path)
    if n_channels == 1:
        return img[..., :1] if img.shape[2] in (1, 2) else \
            _pil_grey(img)[:, :, None]
    return data._rgb(img)


def imsave(img: np.ndarray, img_path: str) -> None:
    """Saves uint8 HxWx3 or HxW (HxWx1) as an 8-bit PNG
    (ref: utils_image.py:161-166) with `data.write_png`."""
    from ..data import write_png
    write_png(img_path, np.squeeze(img))


# ---------------------------------------------------------------------------
# File-system helpers (ref: utils_image.py:25-119)
# ---------------------------------------------------------------------------

IMG_EXTENSIONS = [".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG",
                  ".ppm", ".PPM", ".bmp", ".BMP", ".tif"]


def is_image_file(filename: str) -> bool:
    """ref: utils_image.py:25-26"""
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def get_timestamp() -> str:
    """ref: utils_image.py:29-30"""
    from datetime import datetime
    return datetime.now().strftime("%y%m%d-%H%M%S")


def get_image_paths(dataroot):
    """Sorted recursive image listing; None passes through
    (ref: utils_image.py:66-89)."""
    if dataroot is None:
        return None
    return sorted(_get_paths_from_images(dataroot))


def _get_paths_from_images(path):
    assert os.path.isdir(path), f"{path} is not a valid directory"
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(dirpath, fname))
    assert images, f"{path} has no valid image file"
    return images


def mkdir(path: str) -> None:
    """ref: utils_image.py:92-94"""
    os.makedirs(path, exist_ok=True)


def mkdirs(paths) -> None:
    """ref: utils_image.py:97-102"""
    if isinstance(paths, str):
        mkdir(paths)
    else:
        for path in paths:
            mkdir(path)


def mkdir_and_rename(path: str) -> None:
    """Archive an existing dir under a timestamped name, then recreate
    (ref: utils_image.py:105-110)."""
    if os.path.exists(path):
        new_name = path + "_archived_" + get_timestamp()
        print(f"Path already exists. Rename it to [{new_name}]")
        os.rename(path, new_name)
    os.makedirs(path)


def todevice(x_list, device="cuda"):
    """Moves each tensor of a list to `device` (ref: utils_image.py:122-123)."""
    return [torch.as_tensor(x).to(device) for x in x_list]


def read_img(path: str) -> np.ndarray:
    """HxWxC float32 in [0, 1], BGR channel order
    (ref: utils_image.py:130-143, cv2.imread's semantics)."""
    arr = imread_uint(path, n_channels=3)[:, :, ::-1]  # RGB -> BGR
    return arr.astype(np.float32) / 255.0


# ---------------------------------------------------------------------------
# numpy <-> tensor converters (ref: utils_image.py:205-310): CHW float32
# tensors, as the reference's
# ---------------------------------------------------------------------------

def _hwc(img: np.ndarray) -> np.ndarray:
    return np.expand_dims(img, axis=2) if img.ndim == 2 else img


def _f32(img) -> np.ndarray:
    if torch.is_tensor(img):
        return img.detach().cpu().to(torch.float32).numpy()
    return np.asarray(img, np.float32)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def uint2tensor4(img: np.ndarray) -> torch.Tensor:
    """uint HWC -> float [1, C, H, W] in [0, 1] (ref: utils_image.py:209-212)."""
    return _tensor(_hwc(img).transpose(2, 0, 1))[None] / 255.0


def uint2tensor3(img: np.ndarray) -> torch.Tensor:
    """uint HWC -> float [C, H, W] in [0, 1] (ref: utils_image.py:216-219)."""
    return _tensor(_hwc(img).transpose(2, 0, 1)) / 255.0


def tensor2uint(img) -> np.ndarray:
    """float tensor -> uint8 HWC / HW (ref: utils_image.py:223-227)."""
    arr = _f32(img).squeeze().clip(0, 1)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    return np.uint8((arr * 255.0).round())


def single2tensor4(img: np.ndarray) -> torch.Tensor:
    """single HWC -> [1, C, H, W] (ref: utils_image.py:237-238)."""
    return _tensor(img.transpose(2, 0, 1))[None]


def single2tensor5(img: np.ndarray) -> torch.Tensor:
    """single HWCT -> [1, C, H, W, T] (ref: utils_image.py:241-242)."""
    return _tensor(img.transpose(2, 0, 1, 3))[None]


def single32tensor5(img: np.ndarray) -> torch.Tensor:
    """single HWT -> [1, 1, H, W, T] (ref: utils_image.py:245-246)."""
    return _tensor(img)[None, None]


def single42tensor4(img: np.ndarray) -> torch.Tensor:
    """single HWCT -> [C, H, W, T] (ref: utils_image.py:249-250)."""
    return _tensor(img.transpose(2, 0, 1, 3))


def single2tensor3(img: np.ndarray) -> torch.Tensor:
    """single HWC -> [C, H, W] (ref: utils_image.py:254-255)."""
    return _tensor(img.transpose(2, 0, 1))


def single2tensor2(img: np.ndarray) -> torch.Tensor:
    """single HxWx1 / HxW -> [H, W] (ref: utils_image.py:258-259)."""
    return _tensor(img).squeeze()


def tensor2single(img) -> np.ndarray:
    """tensor -> single HWC / HW clipped to [0, 1]
    (ref: utils_image.py:262-267)."""
    arr = _f32(img).squeeze().clip(0, 1)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    return arr


def tensor2single3(img) -> np.ndarray:
    """tensor2single, but a 2-D result keeps a channel axis
    (ref: utils_image.py:269-275)."""
    return _hwc(tensor2single(img))


def _make_grid_np(batch: np.ndarray, nrow: int, padding: int = 2) -> np.ndarray:
    """torchvision.utils.make_grid semantics (normalize=False): tile BCHW
    into C x grid_h x grid_w with `padding` zero pixels between cells."""
    b, c, h, w = batch.shape
    ncol = int(np.ceil(b / nrow)) if nrow else 1
    nrow = min(nrow, b)
    ymaps = int(np.ceil(b / nrow))
    grid = np.zeros((c, padding + ymaps * (h + padding),
                     padding + nrow * (w + padding)), batch.dtype)
    k = 0
    for y in range(ymaps):
        for x in range(nrow):
            if k >= b:
                break
            grid[:, padding + y * (h + padding):padding + y * (h + padding) + h,
                 padding + x * (w + padding):padding + x * (w + padding) + w] \
                = batch[k]
            k += 1
    return grid


def tensor2img(tensor, out_type=np.uint8, min_max=(0, 1)) -> np.ndarray:
    """4D/3D/2D tensor -> HWC/HW image array in BGR order
    (ref: utils_image.py:279-310; the 4D branch reproduces
    torchvision.utils.make_grid tiling)."""
    arr = _f32(tensor).squeeze()
    arr = arr.clip(*min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if arr.ndim == 4:
        n_img = len(arr)
        grid = _make_grid_np(arr, nrow=int(math.sqrt(n_img)))
        img_np = grid[[2, 1, 0], :, :].transpose(1, 2, 0)
    elif arr.ndim == 3:
        img_np = arr[[2, 1, 0], :, :].transpose(1, 2, 0)
    elif arr.ndim == 2:
        img_np = arr
    else:
        raise TypeError(
            f"tensor2img expects a 2D, 3D, or 4D array, got {arr.ndim}D")
    if out_type == np.uint8:
        img_np = (img_np * 255.0).round()
    return img_np.astype(out_type)


# ---------------------------------------------------------------------------
# Augmentations (ref: utils_image.py:316-426): the dihedral group of order 8
# ---------------------------------------------------------------------------

def augment_img(img, mode: int = 0):
    """Dihedral-group augmentation of an HWC/HW numpy image
    (ref: utils_image.py:316-333 — same mode table)."""
    if mode == 0:
        return img
    elif mode == 1:
        return np.flipud(np.rot90(img))
    elif mode == 2:
        return np.flipud(img)
    elif mode == 3:
        return np.rot90(img, k=3)
    elif mode == 4:
        return np.flipud(np.rot90(img, k=2))
    elif mode == 5:
        return np.rot90(img)
    elif mode == 6:
        return np.rot90(img, k=2)
    elif mode == 7:
        return np.flipud(np.rot90(img, k=3))
    raise ValueError(mode)


def augment_img_tensor4(img: torch.Tensor, mode: int = 0) -> torch.Tensor:
    """The same group on a [B, C, H, W] tensor, on its device
    (ref: utils_image.py:335-352)."""
    hw = (2, 3)
    if mode == 0:
        return img
    if mode == 1:
        return torch.rot90(img, 1, hw).flip(2)
    if mode == 2:
        return img.flip(2)
    if mode == 3:
        return torch.rot90(img, 3, hw)
    if mode == 4:
        return torch.rot90(img, 2, hw).flip(2)
    if mode == 5:
        return torch.rot90(img, 1, hw)
    if mode == 6:
        return torch.rot90(img, 2, hw)
    if mode == 7:
        return torch.rot90(img, 3, hw).flip(2)
    raise ValueError(mode)


def augment_img_np3(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """Transpose/flip variant on HWC numpy (ref: utils_image.py:354-379)."""
    if mode == 0:
        return img
    elif mode == 1:
        return img.transpose(1, 0, 2)
    elif mode == 2:
        return img[::-1, :, :]
    elif mode == 3:
        return img[::-1, :, :].transpose(1, 0, 2)
    elif mode == 4:
        return img[:, ::-1, :]
    elif mode == 5:
        return img[:, ::-1, :].transpose(1, 0, 2)
    elif mode == 6:
        return img[:, ::-1, :][::-1, :, :]
    elif mode == 7:
        return img[:, ::-1, :][::-1, :, :].transpose(1, 0, 2)
    raise ValueError(mode)


def augment_img_tensor(img: torch.Tensor, mode: int = 0) -> torch.Tensor:
    """A [C, H, W] / [B, C, H, W] tensor through the numpy augment_img
    (ref: utils_image.py:382-397), back on its device in its dtype."""
    arr = img.detach().cpu().numpy()
    ndim = arr.ndim
    if ndim == 3:
        arr = arr.transpose(1, 2, 0)
    elif ndim == 4:
        arr = arr.transpose(2, 3, 1, 0)
    arr = augment_img(arr, mode=mode)
    if ndim == 3:
        arr = arr.transpose(2, 0, 1)
    elif ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(img.device)


def augment_imgs(img_list, hflip: bool = True, rot: bool = True, rng=None):
    """Random horizontal-flip / rotation over a list of HWC images
    (ref: utils_image.py:399-414). `rng`: optional numpy Generator /
    RandomState for reproducibility (the reference uses global random)."""
    import random as _random
    draw = rng.random if rng is not None else _random.random
    hflip = hflip and draw() < 0.5
    vflip = rot and draw() < 0.5
    rot90 = rot and draw() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, :]
        if vflip:
            img = img[::-1, :, :]
        if rot90:
            img = img.transpose(1, 0, 2)
        return img

    return [_augment(img) for img in img_list]


def channel_convert(in_c: int, tar_type: str, img_list):
    """BGR <-> gray/y conversions over a list (ref: utils_image.py:522-533;
    the cv2 color conversions are replaced with the ITU-R BT.601 weights
    cv2 itself uses)."""
    if in_c == 3 and tar_type == "gray":
        # cv2.COLOR_BGR2GRAY: Y = 0.299 R + 0.587 G + 0.114 B
        w = np.array([0.114, 0.587, 0.299], np.float32)  # BGR order
        return [np.expand_dims((img.astype(np.float32) * w).sum(-1)
                               .astype(img.dtype), axis=2)
                for img in img_list]
    elif in_c == 3 and tar_type == "y":
        return [np.expand_dims(bgr2ycbcr(img, only_y=True), axis=2)
                for img in img_list]
    elif in_c == 1 and tar_type == "RGB":
        return [np.repeat(img if img.ndim == 3 else img[:, :, None],
                          3, axis=2) for img in img_list]
    return img_list
