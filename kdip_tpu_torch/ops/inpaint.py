"""Inpainting initialisation helpers (port of `kdip_tpu/ops/inpaint.py`;
ref: condition/diffpir_utils/utils_inpaint.py):

- `get_rho_sigma` (ref: utils_inpaint.py:15-25): the plug-and-play HQS
  rho / sigma annealing schedule (numpy);
- `shepard_initialize` (ref: utils_inpaint.py:28-63): inverse-distance
  (Shepard) interpolation of the masked pixels, on the tensor's device, as
  one shifted add per window offset. The window is the reference's
  asymmetric one: its `range(i + lower, i + upper)` leaves out the top
  end, so the offsets run over [-wing, wing - 1], and the last in-bounds
  row and column near the bottom and right edges drop out too; the
  per-offset validity masks reproduce both.

NCHW: the image is [C, H, W] or [H, W] and the mask [H, W].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["get_rho_sigma", "shepard_initialize"]


def get_rho_sigma(sigma: float = 2.55 / 255, iter_num: int = 15,
                  model_sigma2: float = 2.55) -> Tuple[np.ndarray, np.ndarray]:
    """Log-spaced model sigmas from 49 down to `model_sigma2` (on the
    [0, 255] scale) and the penalty weights rho = sigma^2 / sigma_k^2 / 3
    (ref: utils_inpaint.py:15-25)."""
    model_sigmas = np.logspace(np.log10(49.0), np.log10(model_sigma2),
                               iter_num)
    sigmas = model_sigmas / 255.0
    rhos = (sigma ** 2) / (sigmas ** 2) / 3.0
    return rhos, sigmas


def shepard_initialize(image: torch.Tensor, mask: torch.Tensor,
                       window: int = 5, p: int = 2) -> torch.Tensor:
    """Fills the pixels where mask is 0 with the inverse-p-power-distance
    mean of the measured (mask 1) pixels of a `window`-wide neighbourhood
    (ref: utils_inpaint.py:28-63). image [C, H, W] or [H, W], mask [H, W].
    A pixel with no measured neighbour stays 0, as in the reference."""
    squeeze = image.ndim == 2
    x = image[None] if squeeze else image
    h, w = x.shape[-2:]
    m = mask.to(device=x.device, dtype=x.dtype).reshape(h, w)
    wing = window // 2
    dev = x.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    num = torch.zeros_like(x)
    den = torch.zeros((h, w), dtype=x.dtype, device=dev)
    mx = x * m
    for di in range(-wing, wing):
        # the reference's neighbourhood [i - min(wing, i), i + min(wing,
        # h - i - 1)): offset di is valid at row i iff 0 <= i + di < h and
        # di < h - 1 - i
        row_ok = (rows + di >= 0) & (rows + di < h) & (di < h - 1 - rows)
        src_i = (rows + di).clamp(0, h - 1)
        for dj in range(-wing, wing):
            if di == 0 and dj == 0:
                continue  # the centre is the pixel being filled
            weight = 1.0 / float(di ** p + dj ** p)
            col_ok = (cols + dj >= 0) & (cols + dj < w) & (dj < w - 1 - cols)
            ok = (row_ok & col_ok).to(x.dtype)
            src_j = (cols + dj).clamp(0, w - 1)
            num = num + weight * mx[..., src_i, src_j] * ok
            den = den + weight * (m[src_i, src_j] * ok)
    filled = num / torch.where(den > 0, den, torch.ones_like(den))
    out = torch.where(m > 0, x, filled)
    return out[0] if squeeze else out
