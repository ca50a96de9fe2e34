"""DPS auxiliary tools (port of `kdip_tpu/ops/dps_tools.py`; ref:
condition/dps_utils/tools.py, fastmri_utils.py, img_utils.py): bbox and
mask generation, patch extraction and fold / unfold, the fastMRI centred
FFTs with complex as a last axis of 2, quantile normalisation and
thresholding, the TV loss, the exact-posterior log-densities, the optical
flow colouring and `grad_and_value`.

Images are NCHW tensors. Where `kdip_tpu` takes a jax key, the port takes
the draws themselves (`tops`/`lefts`, `deltas`) or a `torch.Generator`
to make them. The flow colouring and the other numpy helpers stay numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Image normalisation helpers (ref: tools.py:10-52, 237-252)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def clear(x) -> np.ndarray:
    """A tensor -> a [0, 1] numpy image (ref: tools.py:249-252)."""
    return normalize_np(_np(x).squeeze())


def clear_color(x) -> np.ndarray:
    """A [1, C, H, W] / [C, H, W] tensor -> a normalised HWC numpy image
    (ref: tools.py:244-247)."""
    x = _np(x).squeeze()
    if x.ndim == 3 and x.shape[0] in (1, 3):  # CHW -> HWC
        x = np.transpose(x, (1, 2, 0))
    return normalize_np(x)


def normalize_np(img: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1] (ref: tools.py:20-25)."""
    img = img - img.min()
    rng = img.max()
    return img / rng if rng > 0 else img


# ---------------------------------------------------------------------------
# bbox / mask generation (ref: tools.py:106-228)
# ---------------------------------------------------------------------------


def random_bbox(image_shape: Tuple[int, int], mask_shape: Tuple[int, int],
                margin: Tuple[int, int] = (0, 0), batch_size: int = 1,
                mask_batch_same: bool = True,
                tops: Optional[Sequence[int]] = None,
                lefts: Optional[Sequence[int]] = None,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Random (top, left, height, width) boxes, int [B, 4]
    (ref: tools.py:106-133): top in [margin_h, H - margin_h - h), left
    likewise, one box for the batch when mask_batch_same. `tops` and
    `lefts` (one or B each) inject the draws, else they come from
    `generator`."""
    ih, iw = image_shape
    h, w = mask_shape
    mh, mw = margin
    n = 1 if mask_batch_same else batch_size
    if tops is None:
        tops = torch.randint(mh, ih - mh - h, (n,), generator=generator)
    if lefts is None:
        lefts = torch.randint(mw, iw - mw - w, (n,), generator=generator)
    boxes = np.stack([np.asarray(tops, np.int64).reshape(n),
                      np.asarray(lefts, np.int64).reshape(n),
                      np.full(n, h), np.full(n, w)], axis=1)
    if mask_batch_same:
        boxes = np.repeat(boxes, batch_size, axis=0)
    return boxes


def bbox2mask(bboxes: np.ndarray, height: int, width: int,
              max_delta_h: int = 0, max_delta_w: int = 0,
              deltas: Optional[np.ndarray] = None,
              generator: Optional[torch.Generator] = None,
              device="cpu") -> torch.Tensor:
    """Boxes -> [B, 1, H, W] {0, 1} masks, 1 inside each box shrunk by a
    random (dh, dw) (ref: tools.py:144-152): dh in [0, max_delta_h // 2],
    dw in [0, max_delta_w // 2]. `deltas` [B, 2] injects them, else they
    come from `generator`."""
    bboxes = np.asarray(bboxes)
    if deltas is None:
        deltas = torch.stack([
            torch.randint(0, max_delta_h // 2 + 1, (len(bboxes),),
                          generator=generator),
            torch.randint(0, max_delta_w // 2 + 1, (len(bboxes),),
                          generator=generator)], 1)
    deltas = np.asarray(deltas, np.int64)
    masks = np.zeros((len(bboxes), 1, height, width), np.float32)
    for i, ((t, l, h, w), (dh, dw)) in enumerate(zip(bboxes, deltas)):
        masks[i, :, t + dh:t + h - dh, l + dw:l + w - dw] = 1.0
    return torch.from_numpy(masks).to(device)


def local_patch(x: torch.Tensor, bbox_list) -> torch.Tensor:
    """Each image's box, cropped (ref: tools.py:165-171); x [B, C, H, W],
    the boxes all of one (h, w)."""
    return torch.stack([x[i, :, t:t + h, l:l + w] for i, (t, l, h, w)
                        in enumerate(np.asarray(bbox_list))])


def mask_image(x: torch.Tensor, bboxes, image_shape: Tuple[int, int],
               max_delta_shape: Tuple[int, int] = (0, 0),
               mask_type: str = "hole", mosaic_unit_size: int = 8,
               deltas: Optional[np.ndarray] = None,
               generator: Optional[torch.Generator] = None):
    """A bbox mask applied to x [B, C, H, W]: "hole" zeroes the box,
    "mosaic" pixelates it with nearest resizes (ref: tools.py:174-192).
    Returns (result, mask [B, 1, H, W])."""
    height, width = image_shape
    mask = bbox2mask(bboxes, height, width, *max_delta_shape, deltas=deltas,
                     generator=generator, device=x.device).to(x.dtype)
    if mask_type == "hole":
        return x * (1.0 - mask), mask
    if mask_type == "mosaic":
        H, W = x.shape[-2:]
        small = F.interpolate(x, size=(H // mosaic_unit_size,
                                       W // mosaic_unit_size),
                              mode="nearest-exact")
        up = F.interpolate(small, size=(height, width), mode="nearest-exact")
        return up * mask + x * (1.0 - mask), mask
    raise NotImplementedError("unrecognized mask type")


def spatial_discounting_mask(mask_shape: Tuple[int, int],
                             gamma: float = 0.9,
                             discounted: bool = True,
                             device="cpu") -> torch.Tensor:
    """Distance-discounted loss weights inside a mask, Yu et al. 2018
    (ref: tools.py:195-226): [1, 1, h, w]."""
    h, w = mask_shape
    if not discounted:
        return torch.ones((1, 1, h, w), device=device)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    vals = np.maximum(gamma ** np.minimum(i, h - i),
                      gamma ** np.minimum(j, w - j))
    return torch.from_numpy(vals[None, None].astype(np.float32)).to(device)


def same_padding_amounts(in_size: int, ksize: int, stride: int,
                         rate: int) -> Tuple[int, int]:
    out = (in_size + stride - 1) // stride
    eff_k = (ksize - 1) * rate + 1
    pad = max(0, (out - 1) * stride + eff_k - in_size)
    return pad // 2, pad - pad // 2


def extract_image_patches(images: torch.Tensor, ksizes, strides, rates,
                          padding: str = "same") -> torch.Tensor:
    """TF-style patch extraction with torch's Unfold (ref: tools.py:56-103):
    images [B, C, H, W] -> [B, C * kh * kw, nH * nW], the patch axis
    ordered (c, kh, kw) and the positions row-major, as the reference's."""
    kh, kw = ksizes
    sh, sw = strides
    rh, rw = rates
    if padding == "same":
        ph = same_padding_amounts(images.shape[-2], kh, sh, rh)
        pw = same_padding_amounts(images.shape[-1], kw, sw, rw)
        images = F.pad(images, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "valid":
        raise NotImplementedError(f"padding {padding}")
    return F.unfold(images, (kh, kw), dilation=(rh, rw), stride=(sh, sw))


# ---------------------------------------------------------------------------
# fastMRI centred FFTs, complex as a last axis of 2 (real, imaginary)
# (ref: fastmri_utils.py:16-200)
# ---------------------------------------------------------------------------


def _to_complex(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] != 2:
        raise ValueError(f"expects (..., 2) real/imag, got {tuple(x.shape)}")
    return torch.complex(x[..., 0], x[..., 1])


def _from_complex(z: torch.Tensor) -> torch.Tensor:
    return torch.stack([z.real, z.imag], -1)


def fft2c(data: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """Centred 2-D FFT over the two axes before the complex axis
    (ref: fastmri_utils.py:67-90 fft2c_new)."""
    z = torch.fft.ifftshift(_to_complex(data), dim=(-2, -1))
    z = torch.fft.fft2(z, norm=norm)
    return _from_complex(torch.fft.fftshift(z, dim=(-2, -1)))


def ifft2c(data: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """(ref: fastmri_utils.py:92-118 ifft2c_new)"""
    z = torch.fft.ifftshift(_to_complex(data), dim=(-2, -1))
    z = torch.fft.ifft2(z, norm=norm)
    return _from_complex(torch.fft.fftshift(z, dim=(-2, -1)))


def fftshift(x: torch.Tensor, dim=None) -> torch.Tensor:
    """(ref: fastmri_utils.py:163-183)"""
    return torch.fft.fftshift(x, dim=dim)


def ifftshift(x: torch.Tensor, dim=None) -> torch.Tensor:
    """(ref: fastmri_utils.py:186-200)"""
    return torch.fft.ifftshift(x, dim=dim)


def roll(x: torch.Tensor, shift, dim) -> torch.Tensor:
    """(ref: fastmri_utils.py:140-160)"""
    return torch.roll(x, shift, dim)


# ---------------------------------------------------------------------------
# Patch fold / unfold, thresholding and other DPS helpers
# (ref: dps_utils/img_utils.py:67-155, 119-141, 230-243, 304-362)
# ---------------------------------------------------------------------------


def center_crop(img: np.ndarray, new_width: Optional[int] = None,
                new_height: Optional[int] = None) -> np.ndarray:
    """Center-crop an HW(C) array (ref: img_utils.py:119-141)."""
    height, width = img.shape[:2]
    new_width = min(width, height) if new_width is None else new_width
    new_height = min(width, height) if new_height is None else new_height
    left = int(np.ceil((width - new_width) / 2))
    right = width - int(np.floor((width - new_width) / 2))
    top = int(np.ceil((height - new_height) / 2))
    bottom = height - int(np.floor((height - new_height) / 2))
    return img[top:bottom, left:right, ...]


def unfold_patches(x: torch.Tensor, crop_size: int = 128,
                   stride: int = 64) -> torch.Tensor:
    """[B, C, H, W] -> [B, n*n, C, crop, crop] sliding patches, row-major
    (the Unfolder, ref: img_utils.py:104-116), by F.unfold."""
    B, C = x.shape[:2]
    p = F.unfold(x, crop_size, stride=stride)  # [B, C*k*k, L]
    return p.reshape(B, C, crop_size, crop_size, -1).permute(0, 4, 1, 2, 3)


def fold_patches(patches: torch.Tensor, img_size: int = 256,
                 stride: int = 64) -> torch.Tensor:
    """The inverse of unfold_patches with overlaps summed (torch's Fold,
    the Folder of ref: img_utils.py:143-154): [B, n*n, C, k, k] ->
    [B, C, img_size, img_size]."""
    b, n, c, k, _ = patches.shape
    cols = patches.permute(0, 2, 3, 4, 1).reshape(b, c * k * k, n)
    return F.fold(cols, img_size, k, stride=stride)


def fold_unfold(x: torch.Tensor, kernel: int, stride: int):
    """Unfold into patches and fold back with the overlaps averaged
    (ref: img_utils.py:67-90): (patches, reassembled), reassembled == x
    wherever the patch grid covers the image."""
    patches = unfold_patches(x, kernel, stride)
    summed = fold_patches(patches, x.shape[-1], stride)
    ones = fold_patches(torch.ones_like(patches), x.shape[-1], stride)
    return patches, summed / ones


def unnormalize(img: torch.Tensor, s: float = 0.95) -> torch.Tensor:
    """img over the s-quantile of |img| (ref: img_utils.py:230-232)."""
    return img / torch.quantile(img.abs(), s)


def normalize_quantile(img: torch.Tensor, s: float = 0.95) -> torch.Tensor:
    """img times the s-quantile of |img| (ref: img_utils.py:235-237)."""
    return img * torch.quantile(img.abs(), s)


def dynamic_thresholding(img: torch.Tensor, s: float = 0.95) -> torch.Tensor:
    """Imagen's dynamic thresholding as the reference writes it
    (ref: img_utils.py:240-243): normalize (a product), then clip."""
    return normalize_quantile(img, s=s).clamp(-1.0, 1.0)


def total_variation_loss(img: torch.Tensor, weight: float) -> torch.Tensor:
    """Squared-difference TV of NCHW img (ref: img_utils.py:358-361)."""
    tv_h = ((img[:, :, 1:, :] - img[:, :, :-1, :]) ** 2).mean()
    tv_w = ((img[:, :, :, 1:] - img[:, :, :, :-1]) ** 2).mean()
    return weight * (tv_h + tv_w)


def create_gaussian(size: int, sigma1: float,
                    sigma2: float = -1.0) -> np.ndarray:
    """Separable un-normalized Gaussian window (ref: img_utils.py:351-355)."""
    zs = np.arange(-size // 2 + 1, size // 2 + 1, dtype=np.float64)
    f1 = np.exp(-zs ** 2 / (2 * sigma1 ** 2)) / np.sqrt(2 * np.pi * sigma1 ** 2)
    if sigma2 == -1:
        f2 = f1
    else:
        f2 = (np.exp(-zs ** 2 / (2 * sigma2 ** 2))
              / np.sqrt(2 * np.pi * sigma2 ** 2))
    return np.outer(f1, f2)


def create_penalty_mask(k_size: int, penalty_scale: float) -> np.ndarray:
    """Boundary-penalty mask for kernel estimation
    (ref: img_utils.py:341-348)."""
    center_size = k_size // 2 + k_size % 2
    mask = create_gaussian(size=k_size, sigma1=k_size)
    mask = 1 - mask / np.max(mask)
    margin = (k_size - center_size) // 2 - 1
    mask[margin:-margin, margin:-margin] = 0
    return penalty_scale * mask


# The exact-posterior densities of small analytic studies
# (ref: img_utils.py:304-333 exact_posterior).

def log_py_given_x0(x0, y, forward_fn, sigma_0: float, input_dim: int):
    """log N(y; A x0, sigma_0^2 I) with the reference's normalisation
    (ref: img_utils.py:310-316)."""
    norm_const = 1.0 / ((2 * np.pi) ** input_dim * sigma_0 ** 2)
    exp_in = -1.0 / (2 * sigma_0 ** 2) * torch.linalg.vector_norm(
        (y - forward_fn(x0)).reshape(-1)) ** 2
    return np.log(np.float32(norm_const)) + exp_in


def log_pxt_given_x0(x0, xt, beta_t, label_dim: int):
    """log N(xt; sqrt(1 - beta_t) x0, beta_t I) with the reference's
    normalisation (ref: img_utils.py:318-324)."""
    norm_const = 1.0 / ((2 * np.pi) ** label_dim * beta_t)
    exp_in = -1.0 / (2 * beta_t) * torch.linalg.vector_norm(
        (xt - np.sqrt(1.0 - beta_t) * x0).reshape(-1)) ** 2
    return np.log(np.float32(norm_const)) + exp_in


# ---------------------------------------------------------------------------
# Reducers and optical-flow colouring (generative-inpainting lineage,
# ref: dps_utils/tools.py:229-267, 270-296, 336-351, 372-398, 434-462,
# 502-527)
# ---------------------------------------------------------------------------


def _axes(x: torch.Tensor, axis):
    return sorted(range(x.ndim) if not axis else axis, reverse=True)


def reduce_mean(x: torch.Tensor, axis=None, keepdim: bool = False):
    """Mean over each axis in turn (ref: tools.py:229-234)."""
    for i in _axes(x, axis):
        x = x.mean(i, keepdim=keepdim)
    return x


def reduce_std(x: torch.Tensor, axis=None, keepdim: bool = False):
    """Std over each axis in turn, the reference's std of stds with
    torch's correction 1 (ref: tools.py:254-259)."""
    for i in _axes(x, axis):
        x = x.std(i, keepdim=keepdim)
    return x


def reduce_sum(x: torch.Tensor, axis=None, keepdim: bool = False):
    """(ref: tools.py:262-267)"""
    for i in _axes(x, axis):
        x = x.sum(i, keepdim=keepdim)
    return x


def make_color_wheel() -> np.ndarray:
    """Middlebury flow color wheel, 55 x 3 uint-valued
    (ref: tools.py:434-462)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros([ry + yg + gc + cb + bm + mr, 3])
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Flow vector field -> Middlebury color coding (ref: tools.py:372-398),
    fully vectorized (the reference already is, minus the channel loop)."""
    u = np.array(u, dtype=np.float64)
    v = np.array(v, dtype=np.float64)
    nan_idx = np.isnan(u) | np.isnan(v)
    u[nan_idx] = 0
    v[nan_idx] = 0
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0
    col0 = wheel[k0 - 1] / 255.0          # [H, W, 3]
    col1 = wheel[k1 - 1] / 255.0
    col = (1 - f[..., None]) * col0 + f[..., None] * col1
    small = (rad <= 1)[..., None]
    col = np.where(small, 1 - rad[..., None] * (1 - col), col * 0.75)
    return np.floor(255 * col * (1 - nan_idx[..., None])).astype(np.uint8) \
        .astype(np.float64)


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """[B, H, W, 2] flow -> [B, H, W, 3] color image, normalized by the
    batch max radius (ref: tools.py:270-296)."""
    flow = np.array(flow, dtype=np.float64)
    u = flow[..., 0]
    v = flow[..., 1]
    unknown = (np.abs(u) > 1e7) | (np.abs(v) > 1e7)
    u[unknown] = 0
    v[unknown] = 0
    maxrad = max(np.sqrt(u ** 2 + v ** 2).max(), -1)
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    out = [compute_color(u[i], v[i]) for i in range(flow.shape[0])]
    return np.float32(np.uint8(out))


def highlight_flow(flow: np.ndarray) -> np.ndarray:
    """Mark integer flow endpoints on a gray canvas
    (ref: tools.py:336-351, incl. its square-loop quirk of iterating
    w over shape[1])."""
    s = flow.shape
    out = []
    for i in range(s[0]):
        img = np.ones((s[1], s[2], 3)) * 144.0
        u = flow[i, :, :, 0]
        v = flow[i, :, :, 1]
        for h in range(s[1]):
            for w in range(s[1]):
                img[int(u[h, w]), int(v[h, w]), :] = 255.0
        out.append(img)
    return np.float32(np.uint8(out))


def deprocess(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] (ref: tools.py:502-504)."""
    return (img + 1.0) / 2.0


def get_model_list(dirname: str, key: str, iteration: int = 0):
    """Latest (or specific-iteration) .pt-style checkpoint path under a
    directory (ref: tools.py:514-527)."""
    if not os.path.exists(dirname):
        return None
    models = sorted(
        os.path.join(dirname, f) for f in os.listdir(dirname)
        if os.path.isfile(os.path.join(dirname, f)) and key in f
        and ".pt" in f)
    if not models:
        return None
    if iteration == 0:
        return models[-1]
    for model in models:
        if f"{iteration:08d}" in model:
            return model
    return None


def find_nearest(array, value) -> int:
    """Index of the nearest entry (ref: utils_model.py:202-205)."""
    array = np.asarray(array)
    return int(np.abs(array - value).argmin())


def grad_and_value(operator_fn, x_hat_fn, x: torch.Tensor,
                   measurement: torch.Tensor):
    """DPS's likelihood gradient d/dx |y - A(x_hat(x))| and the norm
    itself, from one forward (ref: utils_model.py:390-395,
    torch.autograd.grad on the norm). Returns (grad, norm)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        norm = torch.linalg.vector_norm(
            (measurement - operator_fn(x_hat_fn(x))).reshape(-1))
    grad, = torch.autograd.grad(norm, x)
    return grad, norm.detach()
