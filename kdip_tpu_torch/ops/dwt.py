"""Multi-level orthonormal 2-D Haar DWT on NCHW tensors: the hand-written
CUDA kernel (csrc/haar_dwt.cu), its plain PyTorch version, and the
autograd pair that `ops.transforms.OrthoTransform("dwt")` runs.

Port of `kdip_tpu/ops/pallas_dwt.py` (the Pallas kernel) and of the jnp
butterflies it equals (`kdip_tpu/ops/transforms.py:79-149`). The packed
layout is pywt's coeffs_to_array: at each level the approximation block
splits into [[ll, lh], [hl, hh]] quadrants.

A CUDA tensor goes to the kernel, or the call raises; a CPU tensor goes to
the plain version. The transform is orthonormal, so each direction's
backward is the other direction.
"""

from __future__ import annotations

import ctypes
import math

import torch

# A float32 tensor multiplies by this scalar rounded to float32, the
# kernel's constant: the kernel and this version agree bit for bit.
_INV_SQRT2 = 1 / math.sqrt(2.0)
_SOURCE = "haar_dwt.cu"
MAX_LEVEL = 3  # the kernel keeps a 2^level x 2^level tile in registers

# kernel launches since the last reset_launch_counts(), by kernel name
launch_counts = {"haar_dwt2": 0, "haar_idwt2": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def _haar_fwd_axis(x: torch.Tensor, dim: int):
    dim %= x.ndim
    even, odd = x.unflatten(dim, (-1, 2)).unbind(dim + 1)
    return (even + odd) * _INV_SQRT2, (even - odd) * _INV_SQRT2


def _haar_inv_axis(lo: torch.Tensor, hi: torch.Tensor, dim: int):
    dim %= lo.ndim
    even, odd = (lo + hi) * _INV_SQRT2, (lo - hi) * _INV_SQRT2
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def dwt2_plain(x: torch.Tensor, level: int = 3) -> torch.Tensor:
    """Packed `level`-level Haar DWT of every (b, c) plane of NCHW x, with
    slices, adds and torch.cat (`kdip_tpu` transforms.dwt2)."""
    out = x.clone()
    H, W = x.shape[-2:]
    for lv in range(level):
        blk = out[..., :H >> lv, :W >> lv]
        lo, hi = _haar_fwd_axis(blk, -2)
        ll, lh = _haar_fwd_axis(lo, -1)
        hl, hh = _haar_fwd_axis(hi, -1)
        out[..., :H >> lv, :W >> lv] = torch.cat(
            [torch.cat([ll, lh], -1), torch.cat([hl, hh], -1)], -2)
    return out


def idwt2_plain(x: torch.Tensor, level: int = 3) -> torch.Tensor:
    """Inverse (= transpose) of dwt2_plain."""
    out = x.clone()
    H, W = x.shape[-2:]
    for lv in range(level - 1, -1, -1):
        hs, ws = H >> lv, W >> lv
        blk = out[..., :hs, :ws]
        ll, lh = blk[..., :hs // 2, :ws // 2], blk[..., :hs // 2, ws // 2:]
        hl, hh = blk[..., hs // 2:, :ws // 2], blk[..., hs // 2:, ws // 2:]
        rec = _haar_inv_axis(_haar_inv_axis(ll, lh, -1),
                             _haar_inv_axis(hl, hh, -1), -2)
        out[..., :hs, :ws] = rec
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def _kernel():
    from . import _build
    lib = _build.load(_SOURCE)
    fn = lib.haar_dwt2_f32
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def haar_dwt2_cuda(x: torch.Tensor, level: int, inverse: bool) -> torch.Tensor:
    """Launches the kernel on a contiguous NCHW CUDA tensor on the current
    stream. Float dtypes other than float32 are cast around the kernel, as
    the Pallas wrapper does (pallas_dwt.py:83-95)."""
    if not x.is_cuda:
        raise ValueError("haar_dwt2_cuda takes a CUDA tensor")
    if x.ndim != 4 or not x.is_floating_point():
        raise ValueError(f"expected a float NCHW tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("haar_dwt2_cuda takes a contiguous tensor")
    if not 1 <= level <= MAX_LEVEL:
        raise ValueError(f"level must be in 1..{MAX_LEVEL}, got {level}")
    B, C, H, W = x.shape
    if H % (1 << level) or W % (1 << level):
        raise ValueError(f"H, W = {H}, {W} not divisible by 2^{level}")
    fn = _kernel()
    x32 = x.to(torch.float32)
    y = torch.empty_like(x32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x32.data_ptr(), y.data_ptr(), B * C, H, W, level,
                 int(inverse), stream)
    if err != 0:
        raise RuntimeError(f"haar_dwt2 launch failed: cudaError {err}")
    launch_counts["haar_idwt2" if inverse else "haar_dwt2"] += 1
    return y.to(x.dtype)


def _run(x: torch.Tensor, level: int, inverse: bool) -> torch.Tensor:
    if x.is_cuda:
        return haar_dwt2_cuda(x.contiguous(), level, inverse)
    return (idwt2_plain if inverse else dwt2_plain)(x, level)


class _DWT2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, level):
        ctx.level = level
        return _run(x, level, inverse=False)

    @staticmethod
    def backward(ctx, g):
        return _IDWT2.apply(g, ctx.level), None


class _IDWT2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, level):
        ctx.level = level
        return _run(x, level, inverse=True)

    @staticmethod
    def backward(ctx, g):
        return _DWT2.apply(g, ctx.level), None


def dwt2(x: torch.Tensor, level: int = 3) -> torch.Tensor:
    """Packed multi-level Haar DWT of NCHW x; differentiable (the adjoint is
    idwt2)."""
    return _DWT2.apply(x, level)


def idwt2(x: torch.Tensor, level: int = 3) -> torch.Tensor:
    """Inverse of dwt2; differentiable (the adjoint is dwt2)."""
    return _IDWT2.apply(x, level)
