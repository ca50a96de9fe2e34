"""Orthonormal transforms for the learned-covariance guidance (PyTorch port
of `kdip_tpu/ops/transforms.py:49-76, 152-198`; ref: condition/utils.py:
50-163). NCHW. The DWT is the hand-written kernel of `ops.dwt` on the card;
the DCT is plain torch, as `kdip_tpu` runs its DCT in XLA, outside Pallas."""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from . import dwt as _dwt


@functools.lru_cache(maxsize=32)
def _dct_matrix(n: int, device: torch.device) -> torch.Tensor:
    """The orthonormal DCT-II matrix D[k, j] = sqrt(2/n) c_k
    cos(pi (2j + 1) k / (2n)), c_0 = 1/sqrt2, built in float64 on the host
    and cast to float32 on `device`, once per (n, device)."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    d = math.sqrt(2.0 / n) * np.cos(np.pi * (2 * j + 1) * k / (2 * n))
    d[0] /= math.sqrt(2.0)
    return torch.from_numpy(d.astype(np.float32)).to(device)


def _along(x: torch.Tensor, dim: int, transpose: bool) -> torch.Tensor:
    """x with the DCT matrix (or its transpose) applied along `dim` of NCHW
    (1, 2 or 3); a contiguous result."""
    m = _dct_matrix(x.shape[dim], x.device)
    m = m.T if transpose else m
    if dim == 3:
        return x @ m.T
    if dim == 2:
        return m @ x
    B, C, H, W = x.shape
    return (m @ x.reshape(B, C, H * W)).reshape(B, C, H, W)


def _dct_dims(x: torch.Tensor):
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got {tuple(x.shape)}")
    return [d for d in (1, 2, 3) if x.shape[d] > 1]


def dct(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II over every non-batch axis of NCHW x (C, H and W),
    skipping axes of size 1, as `kdip_tpu.ops.transforms.dct` transforms
    every non-batch axis of NHWC (ref: condition/utils.py:88-96)."""
    for d in _dct_dims(x):
        x = _along(x, d, transpose=False)
    return x


def idct(x: torch.Tensor) -> torch.Tensor:
    """Inverse (= transpose) of dct."""
    for d in _dct_dims(x):
        x = _along(x, d, transpose=True)
    return x


class OrthoTransform:
    """Callable pair (forward, inverse) of an orthonormal transform:
    None is the identity, "dwt" the packed `level`-level Haar DWT, "dct"
    the orthonormal DCT-II over C, H and W (ref: condition/utils.py:50-77)."""

    def __init__(self, ortho_tf_type: Optional[str] = None, level: int = 3):
        self.ortho_tf_type = ortho_tf_type
        self.level = level
        if ortho_tf_type not in (None, "dwt", "dct"):
            raise ValueError(f"unknown ortho_tf_type: {ortho_tf_type}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.ortho_tf_type is None:
            return x
        if self.ortho_tf_type == "dct":
            return dct(x)
        return _dwt.dwt2(x, self.level)

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        if self.ortho_tf_type is None:
            return x
        if self.ortho_tf_type == "dct":
            return idct(x)
        return _dwt.idwt2(x, self.level)

    def masked_cov_matvec(self, v: torch.Tensor, theta: torch.Tensor,
                          mask: torch.Tensor, s2: float) -> torch.Tensor:
        """s2 * v + mask * inv(theta * self(v)), the inpainting solve's CG
        matvec (ref: condition.py:317-348): for "dwt" the fused kernel of
        `ops.dwt.ot_matvec`, one launch on the card."""
        if self.ortho_tf_type is None:
            return s2 * v + mask * (theta * v)
        if self.ortho_tf_type == "dwt":
            return _dwt.ot_matvec(v, theta, mask, s2, self.level)
        return s2 * v + mask * self.inv(theta * self(v))


def ot_covariance(ortho_tf: OrthoTransform, variance: torch.Tensor) -> Callable:
    """C = W diag(v) W^T as a matvec closure
    (ref: condition/utils.py:146-163 LazyOTCovariance); for "dwt" the fused
    kernel's no-mask mode, which takes contiguous tensors (x may be a
    strided view, such as the real part of an inverse FFT)."""
    def matvec(x):
        if ortho_tf.ortho_tf_type == "dwt":
            return _dwt.ot_matvec(x.contiguous(), variance,
                                  level=ortho_tf.level)
        return ortho_tf.inv(ortho_tf(x) * variance)
    return matvec
