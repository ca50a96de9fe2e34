"""Multi-level orthonormal 2-D Haar DWT on NCHW tensors: the hand-written
CUDA kernel (csrc/haar_dwt.cu), its plain PyTorch version, the autograd
pair that `ops.transforms.OrthoTransform("dwt")` runs, and the fused
covariance matvec of DWT-Var's CG solve.

Port of `kdip_tpu/ops/pallas_dwt.py` (the Pallas kernel) and of the jnp
butterflies it equals (`kdip_tpu/ops/transforms.py:79-149`). The packed
layout is pywt's coeffs_to_array: at each level the approximation block
splits into [[ll, lh], [hl, hh]] quadrants.

A CUDA tensor goes to the kernel, or the call raises; a CPU tensor goes to
the plain version. The transform is orthonormal, so each direction's
backward is the other direction.

The kernel takes levels 1..MAX_LEVEL in one pass. `dwt2`, `idwt2` and
`ot_matvec` take any level whose 2^level divides H and W: past MAX_LEVEL
they chain passes on the top-left approximation block, copied out
contiguous and written back (each level maps that block alone, so the
chain is bit-equal to the plain version).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

# A float32 tensor multiplies by this scalar rounded to float32, the
# kernel's constant: the kernel and this version agree bit for bit.
_INV_SQRT2 = 1 / math.sqrt(2.0)
_SOURCE = "haar_dwt.cu"
MAX_LEVEL = 3  # the kernel instantiates levels 1..3 (one pass)

# kernel launches since the last reset_launch_counts(), by kernel name, and
# the fused matvec's launches by mode (with a mask: the inpainting CG's
# matvec; without: ot_covariance)
launch_counts = {"haar_dwt2": 0, "haar_idwt2": 0, "haar_ot_matvec": 0}
matvec_mode_counts = {"mask": 0, "no_mask": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, matvec_mode_counts):
        for k in counts:
            counts[k] = 0


def check_level(H: int, W: int, level: int, max_level: Optional[int] = None
                ) -> None:
    """Raises unless level >= 1 (and <= max_level where given) and 2^level
    divides H and W."""
    top = "" if max_level is None else f"..{max_level}"
    if level < 1 or (max_level is not None and level > max_level):
        raise ValueError(f"level must be in 1{top}, got {level}")
    if H % (1 << level) or W % (1 << level):
        raise ValueError(f"H, W = {H}, {W} not divisible by 2^{level}")


def passes(level: int) -> Tuple[Tuple[int, int], ...]:
    """The kernel passes of a `level`-level transform, forward order:
    (levels already done, levels of this pass); each pass maps the
    top-left (H >> done, W >> done) block."""
    return tuple((done, min(level - done, MAX_LEVEL))
                 for done in range(0, level, MAX_LEVEL))


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


def ot_matvec_plain(v: torch.Tensor, theta: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, s2: float = 0.0,
                    level: int = 3) -> torch.Tensor:
    """s2 * v + mask * idwt2(theta * dwt2(v)), composed as DWT-Var's CG
    matvec composes it (`kdip_tpu` guidance.py:394-395); without a mask,
    idwt2(theta * dwt2(v)) (`ot_covariance`)."""
    w = idwt2_plain(theta * dwt2_plain(v, level), level)
    return w if mask is None else s2 * v + mask * w


# ---------------------------------------------------------------------------
# The launch: how many threads a CTA, and how wide each thread's patch
# ---------------------------------------------------------------------------

MIN_CTAS = 132            # the H100's SMs: a launch aims at one CTA each
THREADS = (256, 128, 64, 32)  # CTA sizes, largest first


class LaunchConfig(NamedTuple):
    """What the kernel is launched with: `threads` a CTA, each owning a
    2 x `vec` patch of one plane (vec floats a load or store)."""
    threads: int
    vec: int


def launch_shape(cfg: LaunchConfig, planes: int, H: int, W: int) -> int:
    """The CTAs of a launch, as the kernel computes them (launch_dims in
    haar_dwt.cu): one thread a 2 x vec patch."""
    patches = planes * H * W // (2 * cfg.vec)
    return -(-patches // cfg.threads)


@functools.lru_cache(maxsize=256)
def launch_config(planes: int, H: int, W: int, vec: int = 4) -> LaunchConfig:
    """The launch over [planes, H, W], at any level: 16-byte accesses
    (vec 4) where rows are whole float4s, else 8-byte ones (vec 2); and the
    largest CTA that still gives MIN_CTAS CTAs, else 32 threads. At
    [1, 3, 256, 256]: 128 threads, 192 CTAs."""
    if vec == 4 and W % 4:
        vec = 2
    for threads in THREADS:
        cfg = LaunchConfig(threads, vec)
        if launch_shape(cfg, planes, H, W) >= MIN_CTAS:
            return cfg
    return cfg


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

# The C entry points' parameters (pointers must not pass as 32-bit ints):
# haar_dwt2_f32(x, y, planes, H, W, level, inverse, threads, vec, stream)
# haar_ot_matvec_f32(v, theta, mask, s2, y, planes, H, W, level,
#                    theta_planes, mask_planes, threads, vec, stream)
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ARGTYPES = {
    "haar_dwt2_f32": [_P, _P, _I64, _I, _I, _I, _I, _I, _I, _P],
    "haar_ot_matvec_f32": [_P, _P, _P, ctypes.c_float, _P, _I64, _I, _I, _I,
                           _I, _I, _I, _I, _P],
}
_fns = None  # (transform, matvec): the library's entry points, argtypes set


def _kernels():
    global _fns
    if _fns is None:
        from . import _build
        lib = _build.load(_SOURCE)
        fns = []
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns.append(fn)
        _fns = tuple(fns)
    return _fns


def _stream(dev: torch.device) -> int:
    """The raw handle of `dev`'s current stream, without a Stream object
    where PyTorch offers that."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _config(planes: int, H: int, W: int, ptrs) -> LaunchConfig:
    """launch_config, with 8-byte accesses where a pointer is not 16-byte
    aligned (a view that starts inside a storage); a pointer that is not
    8-byte aligned is refused."""
    low = 0
    for p in ptrs:
        low |= p
    if low % 8:
        raise ValueError("the Haar kernel takes tensors whose data are "
                         "8-byte aligned")
    return launch_config(planes, H, W, 2 if low % 16 else 4)


def _launch(fn, dev: torch.device, *args) -> None:
    """Calls the C entry point fn(*args, stream) on dev's current stream,
    entering dev only where it is not the current device; raises on the
    launch's error."""
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        err = fn(*args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def haar_dwt2_cuda(x: torch.Tensor, level: int, inverse: bool) -> torch.Tensor:
    """Launches the transform on a contiguous NCHW CUDA tensor on the
    current stream. Float dtypes other than float32 are cast around the
    kernel, as the Pallas wrapper does (pallas_dwt.py:83-95)."""
    if not x.is_cuda:
        raise ValueError("haar_dwt2_cuda takes a CUDA tensor")
    if x.ndim != 4 or not x.is_floating_point():
        raise ValueError(f"expected a float NCHW tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("haar_dwt2_cuda takes a contiguous tensor")
    B, C, H, W = x.shape
    check_level(H, W, level, MAX_LEVEL)
    tf, _ = _kernels()
    x32 = x if x.dtype == torch.float32 else x.to(torch.float32)
    y = torch.empty_like(x32)
    xp, yp = x32.data_ptr(), y.data_ptr()
    _launch(tf, x.device, xp, yp, B * C, H, W, level, int(inverse),
            *_config(B * C, H, W, (xp, yp)))
    launch_counts["haar_idwt2" if inverse else "haar_dwt2"] += 1
    return y if x.dtype == torch.float32 else y.to(x.dtype)


def _matvec_planes(v: torch.Tensor, theta: torch.Tensor,
                   mask: Optional[torch.Tensor], s2: float, level: int,
                   max_level: Optional[int] = MAX_LEVEL
                   ) -> Tuple[int, int, int]:
    """Checks the matvec's arguments; returns (v's planes, theta's planes,
    the mask's planes). theta and the mask have v's shape or repeat over
    its batch ([1, C, H, W])."""
    if v.ndim != 4:
        raise ValueError(f"expected NCHW v, got {tuple(v.shape)}")
    shape = v.shape
    B, C, H, W = shape
    check_level(H, W, level, max_level)
    if mask is None and s2 != 0:
        raise ValueError("s2 * v is added only with a mask")
    planes = [0, 0]
    for i, (name, t) in enumerate((("theta", theta), ("mask", mask))):
        if t is None:
            continue
        if t.shape == shape:
            planes[i] = B * C
        elif t.shape[0] == 1 and t.shape[1:] == shape[1:]:
            planes[i] = C
        else:
            raise ValueError(f"{name} {tuple(t.shape)} is neither v's shape "
                             f"{tuple(shape)} nor one sample of it")
    for t in (v, theta, mask):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"the matvec takes float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the matvec takes contiguous tensors")
    return B * C, planes[0], planes[1]


def haar_ot_matvec_cuda(v: torch.Tensor, theta: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, s2: float = 0.0,
                        level: int = 3) -> torch.Tensor:
    """Launches the fused matvec y = s2*v + mask * idwt2(theta * dwt2(v))
    (without a mask, idwt2(theta * dwt2(v))) on the current stream: float32
    contiguous NCHW CUDA tensors, theta and the mask of v's shape or
    [1, C, H, W]. Every argument is checked before the launch. Not
    differentiable: the CG solve never asks for a gradient."""
    planes, tplanes, mplanes = _matvec_planes(v, theta, mask, s2, level)
    ts = (v, theta) if mask is None else (v, theta, mask)
    if not all(t.is_cuda and t.device == v.device for t in ts):
        raise ValueError("haar_ot_matvec_cuda takes CUDA tensors on one "
                         "device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("haar_ot_matvec_cuda is not differentiable")
    _, mv = _kernels()
    y = torch.empty_like(v)
    ptrs = (v.data_ptr(), theta.data_ptr(),
            0 if mask is None else mask.data_ptr(), y.data_ptr())
    _, _, H, W = v.shape
    _launch(mv, v.device, *ptrs[:3], s2, ptrs[3], planes, H, W, level,
            tplanes, mplanes, *_config(planes, H, W, ptrs))
    launch_counts["haar_ot_matvec"] += 1
    matvec_mode_counts["no_mask" if mask is None else "mask"] += 1
    return y


def ot_matvec(v: torch.Tensor, theta: torch.Tensor,
              mask: Optional[torch.Tensor] = None, s2: float = 0.0,
              level: int = 3) -> torch.Tensor:
    """s2 * v + mask * idwt2(theta * dwt2(v)) (without a mask,
    idwt2(theta * dwt2(v))): DWT-Var's CG matvec, on a CUDA tensor in one
    launch up to MAX_LEVEL and past it as the chained transforms around
    theta (ot_matvec_plain's composition on the card); ot_matvec_plain on
    a CPU tensor. theta and the mask have v's shape or repeat over its
    batch."""
    if v.is_cuda and level <= MAX_LEVEL:
        return haar_ot_matvec_cuda(v, theta, mask, s2, level)
    _matvec_planes(v, theta, mask, s2, level, max_level=None)
    if v.is_cuda:
        return _chained_matvec(v, theta, mask, s2, level)
    return ot_matvec_plain(v, theta, mask, s2, level)


def _chained_matvec(v, theta, mask, s2: float, level: int) -> torch.Tensor:
    """ot_matvec past MAX_LEVEL: ot_matvec_plain's composition with the
    chained kernel passes for the two transforms."""
    w = _chain(theta * _chain(v, level, False), level, True)
    return w if mask is None else s2 * v + mask * w


def _chain(x: torch.Tensor, level: int, inverse: bool) -> torch.Tensor:
    """The transform of a contiguous CUDA tensor as kernel passes: the
    first on the whole plane, each later one on the approximation block,
    copied out contiguous and written back; the inverse in reverse."""
    (_, first), *rest = passes(level)
    if not rest:
        return haar_dwt2_cuda(x, level, inverse)
    H, W = x.shape[-2:]
    out = x.clone() if inverse else haar_dwt2_cuda(x, first, False)
    for done, n in (reversed(rest) if inverse else rest):
        blk = out[..., :H >> done, :W >> done]
        blk.copy_(haar_dwt2_cuda(blk.contiguous(), n, inverse))
    return haar_dwt2_cuda(out, first, True) if inverse else out


def _run(x: torch.Tensor, level: int, inverse: bool) -> torch.Tensor:
    check_level(*x.shape[-2:], level)
    if x.is_cuda:
        return _chain(x.contiguous(), level, inverse)
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
