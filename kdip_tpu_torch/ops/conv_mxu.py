"""Three formulations of the same-padded 3x3 conv (port of
`kdip_tpu/ops/conv_mxu.py`), kept so that a per-stage A/B of the UNet's
convs can put them side by side: each is F.conv2d's function within
float32 rounding.

x is NCHW [B, C, H, W] and the kernel OIHW [F, C, 3, 3], as torch's
convs take them:

- `conv3x3_nchw`: F.conv2d (cuDNN on the card);
- `conv3x3_nhwc`: the conv run on channels-last memory (the layout in
  which cuDNN picks its tensor-core kernels), the result NCHW again;
- `conv3x3_im2col`: the 9 shifted views concatenated on the channel axis
  and one [B*H*W, 9*C] x [9*C, F] matrix product (cuBLAS), the largest
  single contraction, at the cost of a 9x larger input to it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv3x3_nchw(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The baseline: F.conv2d, NCHW / OIHW."""
    return F.conv2d(x, kernel, bias, padding=1)


def conv3x3_nhwc(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layout variant: the conv on channels-last (NHWC) memory; the
    conversions at the boundary are part of what an A/B measures."""
    cl = torch.channels_last
    y = F.conv2d(x.contiguous(memory_format=cl),
                 kernel.contiguous(memory_format=cl), bias, padding=1)
    return y.contiguous()


def conv3x3_im2col(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   dtype=None) -> torch.Tensor:
    """Explicit im2col: 9 shifted views of the zero-padded x concatenated
    on the channel axis, in (i, j, c) order, then one matrix product in
    `dtype` (default: x's) against the kernel reshaped to [9*C, F]."""
    B, C, H, W = x.shape
    dtype = dtype or x.dtype
    xp = F.pad(x, (1, 1, 1, 1))
    cols = [xp[:, :, i:i + H, j:j + W] for i in range(3) for j in range(3)]
    patches = torch.cat(cols, 1).to(dtype)            # [B, 9*C, H, W]
    patches = patches.permute(0, 2, 3, 1).reshape(B * H * W, 9 * C)
    w = kernel.permute(2, 3, 1, 0).reshape(9 * C, -1).to(dtype)
    y = (patches @ w).reshape(B, H, W, -1).permute(0, 3, 1, 2)
    y = y.to(x.dtype)
    return y if bias is None else y + bias[:, None, None]
