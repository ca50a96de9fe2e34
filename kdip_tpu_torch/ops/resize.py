"""Exact antialiased resampling as two matrix products (port of
`kdip_tpu/ops/resize.py`; ref: condition/dps_utils/resizer.py:8-197).

The per-dimension contributions of the reference's `Resizer` are built once
on the host in numpy (`resize_matrix`, bit-equal to `kdip_tpu`'s) into dense
[out, in] matrices; resizing an NCHW tensor is then Mh @ x @ Mw^T, H first.
On the card these are float32 matmuls: they stay float32 only while
`torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).

`jax_resize` follows `jax.image.resize` instead (bilinear or Keys bicubic,
antialiased when downsampling, taps outside the image dropped), the
resize of `kdip_tpu`'s FID/KID backbones; its matrices come from
`jax_resize_matrix`, and it is applied the same way.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


def cubic(x):
    """Keys cubic interpolation kernel (ref: resizer.py:173-178)."""
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
            + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
            * ((1 < absx) & (absx <= 2)))


def lanczos2(x):
    eps = np.finfo(np.float32).eps
    return (((np.sin(math.pi * x) * np.sin(math.pi * x / 2) + eps)
             / ((math.pi ** 2 * x ** 2 / 2) + eps)) * (np.abs(x) < 2))


def lanczos3(x):
    eps = np.finfo(np.float32).eps
    return (((np.sin(math.pi * x) * np.sin(math.pi * x / 3) + eps)
             / ((math.pi ** 2 * x ** 2 / 3) + eps)) * (np.abs(x) < 3))


def box(x):
    return ((-0.5 <= x) & (x < 0.5)) * 1.0


def linear(x):
    return (x + 1) * ((-1 <= x) & (x < 0)) + (1 - x) * ((0 <= x) & (x <= 1))


_METHODS = {
    "cubic": (cubic, 4.0),
    "lanczos2": (lanczos2, 4.0),
    "lanczos3": (lanczos3, 6.0),
    "box": (box, 1.0),
    "linear": (linear, 2.0),
    None: (cubic, 4.0),
}


def resize_matrix(in_length: int, out_length: int, scale: float,
                  kernel: Optional[str] = None,
                  antialiasing: bool = True) -> np.ndarray:
    """Dense [out_length, in_length] float32 resampling matrix of one
    dimension (ref: resizer.py:104-167 `contributions`): the kernel
    stretched for antialiasing when downscaling, the centre-preserving
    coordinate map, normalised weights, mirror boundary."""
    method, kernel_width = _METHODS[kernel]
    antialiasing = antialiasing and (scale < 1)
    fixed_kernel = ((lambda arg: scale * method(scale * arg)) if antialiasing
                    else method)
    kernel_width = kernel_width / scale if antialiasing else kernel_width

    out_coordinates = np.arange(1, out_length + 1)
    shifted = out_coordinates - (out_length - in_length * scale) / 2
    match_coordinates = shifted / scale + 0.5 * (1 - 1 / scale)
    left_boundary = np.floor(match_coordinates - kernel_width / 2)
    expanded_kernel_width = int(np.ceil(kernel_width)) + 2
    field_of_view = (left_boundary[:, None] + np.arange(expanded_kernel_width)
                     - 1).astype(np.int64)
    weights = fixed_kernel(match_coordinates[:, None] - field_of_view - 1)
    sum_weights = weights.sum(axis=1)
    sum_weights[sum_weights == 0] = 1.0
    weights = weights / sum_weights[:, None]
    # mirror boundary (ref: resizer.py:158-159)
    mirror = np.concatenate([np.arange(in_length),
                             np.arange(in_length - 1, -1, -1)])
    field_of_view = mirror[np.mod(field_of_view, mirror.shape[0])]

    M = np.zeros((out_length, in_length), dtype=np.float64)
    np.add.at(M, (np.repeat(np.arange(out_length), field_of_view.shape[1]),
                  field_of_view.ravel()), weights.ravel())
    return M.astype(np.float32)


def apply_resize(x: torch.Tensor, Mh: torch.Tensor,
                 Mw: torch.Tensor) -> torch.Tensor:
    """Mh @ x @ Mw^T over the H and W of NCHW x: [.., H, W] -> [.., h, w]."""
    return torch.matmul(torch.matmul(Mh, x), Mw.transpose(0, 1))


def make_resizer(in_hw: Tuple[int, int], scale_factor: float,
                 kernel: Optional[str] = None, antialiasing: bool = True,
                 device="cuda"):
    """Returns (resize_fn, (Mh, Mw)) with float32 matrices on `device`:
    resize_fn maps NCHW [B, C, H, W] -> [B, C, H', W']; the matrices give
    the exact adjoint (their transposes)."""
    H, W = in_hw
    out_h = int(np.ceil(H * scale_factor))
    out_w = int(np.ceil(W * scale_factor))
    Mh, Mw = (torch.from_numpy(resize_matrix(n, o, scale_factor, kernel,
                                             antialiasing)).to(device)
              for n, o in ((H, out_h), (W, out_w)))
    return (lambda x: apply_resize(x, Mh, Mw)), (Mh, Mw)


def resize(x: torch.Tensor, scale_factor: float, kernel: Optional[str] = None,
           antialiasing: bool = True) -> torch.Tensor:
    """One-shot exact resize of an NCHW batch, on x's device."""
    fn, _ = make_resizer(tuple(x.shape[-2:]), scale_factor, kernel,
                         antialiasing, device=x.device)
    return fn(x)


# ---------------------------------------------------------------------------
# jax.image.resize's semantics (jax/_src/image/scale.py compute_weight_mat)
# ---------------------------------------------------------------------------

def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    """Keys' cubic with a = -0.5 (F.interpolate's bicubic uses -0.75), in
    x's float32."""
    c = np.float32
    out = ((c(1.5) * x - c(2.5)) * x) * x + c(1)
    out = np.where(x >= 1, ((c(-0.5) * x + c(2.5)) * x - c(4)) * x + c(2),
                   out)
    return np.where(x >= 2, c(0), out)


_JAX_KERNELS = {"linear": _triangle, "bilinear": _triangle,
                "cubic": _keys_cubic, "bicubic": _keys_cubic}


def jax_resize_matrix(in_size: int, out_size: int, method: str,
                      antialias: bool = True) -> np.ndarray:
    """Dense [out_size, in_size] float32 matrix of `jax.image.resize` along
    one axis (its `compute_weight_mat` with translation 0): half-pixel
    centres; when downsampling with `antialias` (jax's default) the kernel
    is widened by 1/scale; taps that fall outside the input are dropped
    and the rest renormalised to sum to 1 (F.interpolate clamps the index
    instead). Computed in float32, step for step as jax computes it with
    x64 off: a sample's position near 512 carries float32's rounding, which
    moves its weights by ~3e-5."""
    f32 = np.float32
    kernel = _JAX_KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0) if antialias else 1.0)
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
              - f32(0.0) - f32(0.5))
    w = kernel(np.abs(sample[:, None] - np.arange(in_size, dtype=f32)[None])
               / kernel_scale).astype(f32)
    total = w.sum(axis=1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, f32(0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _jax_resize_matrices(in_hw: Tuple[int, int], size: Tuple[int, int],
                         method: str, antialias: bool, device: torch.device):
    """(Mh, Mw) of `jax_resize` on `device`, built once per shape, method
    and device; an axis whose size does not change keeps it (the
    identity), as in jax."""
    def matrix(n, o):
        m = (np.eye(n, dtype=np.float32) if n == o
             else jax_resize_matrix(n, o, method, antialias))
        return torch.from_numpy(m).to(device)
    return tuple(matrix(n, o) for n, o in zip(in_hw, size))


def jax_resize(x: torch.Tensor, size: Tuple[int, int], method: str,
               antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize` of an NCHW batch's H and W to `size`, method
    "bilinear" (or "linear") or "bicubic" (or "cubic"): Mh @ x @ Mw^T in
    float32 on x's device, as `kdip_tpu` resizes the Inception, pixels and
    CLIP inputs."""
    Mh, Mw = _jax_resize_matrices(tuple(x.shape[-2:]), tuple(size), method,
                                  antialias, x.device)
    return apply_resize(x.to(torch.float32), Mh, Mw)
