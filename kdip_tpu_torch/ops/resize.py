"""Exact antialiased resampling as two matrix products (port of
`kdip_tpu/ops/resize.py`; ref: condition/dps_utils/resizer.py:8-197).

The per-dimension contributions of the reference's `Resizer` are built once
on the host in numpy (`resize_matrix`, bit-equal to `kdip_tpu`'s) into dense
[out, in] matrices; resizing an NCHW tensor is then Mh @ x @ Mw^T, H first.
On the card these are float32 matmuls: they stay float32 only while
`torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).
"""

from __future__ import annotations

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
