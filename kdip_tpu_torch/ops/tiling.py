"""Tiled and self-ensembled inference around any `apply(x) -> y` on NCHW
tensors (port of `kdip_tpu/ops/tiling.py`; ref:
condition/diffpir_utils/utils_model.py:16-199): replication padding to a
modulo, the receptive-field-aware recursive quadrant split with overlap
stitching, and the x8 dihedral self-ensemble.

Host-level orchestration: Python recursion over the tiles, each `apply`
call on the tensor's own device. A tile's shape follows the image's (512
px splits into 288 px tiles), so a model under `apply` sees shapes it may
route differently: the ADM UNet's Winograd torso takes the direct conv at
a level whose H or W is odd (models/layers.py).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def replication_pad_to_modulo(x: torch.Tensor, modulo: int) -> torch.Tensor:
    """Edge-pad bottom and right so that H and W are multiples of modulo
    (ref: utils_model.py:67-74 test_pad)."""
    h, w = x.shape[-2:]
    pad_b = int(math.ceil(h / modulo) * modulo - h)
    pad_r = int(math.ceil(w / modulo) * modulo - w)
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, pad_r, 0, pad_b), mode="replicate")


def apply_padded(apply: Callable, x: torch.Tensor, modulo: int = 16,
                 sf: int = 1) -> torch.Tensor:
    """Mode 1, 'pad' (ref: utils_model.py:67-74)."""
    h, w = x.shape[-2:]
    y = apply(replication_pad_to_modulo(x, modulo))
    return y[..., :h * sf, :w * sf]


def split_tiles(h: int, w: int, refield: int = 32):
    """The four overlapping quadrants (rows, cols) slices of an h x w
    image: each reaches past the middle by up to one receptive field."""
    th = (h // 2 // refield + 1) * refield
    tw = (w // 2 // refield + 1) * refield
    top, bottom = slice(0, th), slice(h - th, h)
    left, right = slice(0, tw), slice(w - tw, w)
    return [(top, left), (top, right), (bottom, left), (bottom, right)]


def apply_split(apply: Callable, x: torch.Tensor, refield: int = 32,
                min_size: int = 256, sf: int = 1, modulo: int = 1,
                once: bool = False) -> torch.Tensor:
    """Recursive quadrant split with receptive-field overlap
    (ref: utils_model.py:84-117 test_split_fn, 121-145 test_onesplit).
    The tiles overlap by the receptive field and only each tile's inner
    quadrant of output is kept, so the seams see full context."""
    h, w = x.shape[-2:]
    if not once and h * w <= min_size ** 2:
        return apply_padded(apply, x, modulo, sf)
    tiles = [x[..., r, c] for r, c in split_tiles(h, w, refield)]
    if once or h * w <= 4 * (min_size ** 2):
        outs = [apply(t) for t in tiles]
    else:
        outs = [apply_split(apply, t, refield, min_size, sf, modulo)
                for t in tiles]
    hh, hw = h // 2 * sf, w // 2 * sf
    rh, rw = (-h + h // 2) * sf, (-w + w // 2) * sf
    top = torch.cat([outs[0][..., :hh, :hw], outs[1][..., :hh, rw:]], -1)
    bottom = torch.cat([outs[2][..., rh:, :hw], outs[3][..., rh:, rw:]], -1)
    return torch.cat([top, bottom], -2)


def augment_img(x: torch.Tensor, mode: int) -> torch.Tensor:
    """The 8 dihedral transforms of the H, W axes, in KAIR's numbering
    (`kdip_tpu` tiling.py:80-99): mode 0..7."""
    hw = (-2, -1)
    if mode == 0:
        return x
    if mode == 1:
        return torch.rot90(x.flip(-2), 1, hw)
    if mode == 2:
        return x.flip(-2)
    if mode == 3:
        return torch.rot90(x, 3, hw)
    if mode == 4:
        return torch.rot90(x.flip(-2), 2, hw)
    if mode == 5:
        return torch.rot90(x, 1, hw)
    if mode == 6:
        return torch.rot90(x, 2, hw)
    if mode == 7:
        return torch.rot90(x.flip(-2), 3, hw)
    raise ValueError(mode)


def apply_x8(apply: Callable, x: torch.Tensor, modulo: int = 1,
             split: bool = False, **split_kw) -> torch.Tensor:
    """x8 dihedral self-ensemble (ref: utils_model.py:167-178 test_x8,
    184-194 test_split_x8): the mean of the de-augmented outputs over the
    8 transforms; modes 3 and 5 invert with 8 - i."""
    outs = []
    for i in range(8):
        xi = augment_img(x, i)
        yi = (apply_split(apply, xi, modulo=modulo, **split_kw) if split
              else apply_padded(apply, xi, modulo))
        outs.append(augment_img(yi, 8 - i if i in (3, 5) else i))
    return torch.stack(outs).mean(0)


def tiled_inference(apply: Callable, x: torch.Tensor, mode: int = 0,
                    refield: int = 32, min_size: int = 256, sf: int = 1,
                    modulo: int = 1) -> torch.Tensor:
    """The reference's test_mode ids (ref: utils_model.py:16-45): 0 normal,
    1 pad, 2 split, 3 x8, 4 split + x8, 5 one split."""
    if mode == 0:
        return apply(x)
    if mode == 1:
        return apply_padded(apply, x, modulo, sf)
    if mode == 2:
        return apply_split(apply, x, refield, min_size, sf, modulo)
    if mode == 3:
        return apply_x8(apply, x, modulo)
    if mode == 4:
        return apply_x8(apply, x, modulo, split=True, refield=refield,
                        min_size=min_size, sf=sf)
    if mode == 5:
        return apply_split(apply, x, refield, min_size, sf, modulo, once=True)
    raise ValueError(f"unknown tiling mode {mode}")
