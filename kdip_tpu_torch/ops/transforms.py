"""Orthonormal transforms for the learned-covariance guidance (PyTorch port
of `kdip_tpu/ops/transforms.py:152-198`; ref: condition/utils.py:50-163).
NCHW. The DWT is the hand-written kernel of `ops.dwt` on the card."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import dwt as _dwt


class OrthoTransform:
    """Callable pair (forward, inverse) of an orthonormal transform:
    None is the identity, "dwt" the packed `level`-level Haar DWT
    (ref: condition/utils.py:50-77)."""

    def __init__(self, ortho_tf_type: Optional[str] = None, level: int = 3):
        self.ortho_tf_type = ortho_tf_type
        self.level = level
        if ortho_tf_type == "dct":
            raise NotImplementedError(
                "the DCT transform (DCT-Var) is not ported yet: a later slice")
        if ortho_tf_type not in (None, "dwt"):
            raise ValueError(f"unknown ortho_tf_type: {ortho_tf_type}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.ortho_tf_type is None:
            return x
        return _dwt.dwt2(x, self.level)

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        if self.ortho_tf_type is None:
            return x
        return _dwt.idwt2(x, self.level)

    def masked_cov_matvec(self, v: torch.Tensor, theta: torch.Tensor,
                          mask: torch.Tensor, s2: float) -> torch.Tensor:
        """s2 * v + mask * inv(theta * self(v)), the inpainting solve's CG
        matvec (ref: condition.py:317-348): for "dwt" the fused kernel of
        `ops.dwt.ot_matvec`, one launch on the card."""
        if self.ortho_tf_type is None:
            return s2 * v + mask * (theta * v)
        return _dwt.ot_matvec(v, theta, mask, s2, self.level)


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
