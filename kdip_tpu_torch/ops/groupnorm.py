"""GroupNorm with float32 statistics, an optional FiLM scale and shift and an
optional SiLU, forward and backward: the hand-written CUDA kernels
(csrc/groupnorm_silu.cu), their plain PyTorch versions, and the autograd
Functions that `models.layers.GroupNorm32` runs.

Two forms:

- `group_norm`: y = silu((gn(x) * (1 + s)) + t), the FiLM terms s, t ([B, C]
  in x's dtype) and the SiLU each optional. The roundings are the eager
  direct path's: gn(x) = x*a + b in float32, rounded to x's dtype; 1 + s,
  the product and the sum each rounded to x's dtype; SiLU in float32,
  rounded. One launch forward; one backward.
- `affine_terms`: only (a, b), each [B, C] float32 with gn(x) == x*a + b
  before the rounding, the prologue that the Winograd kernel takes. One
  launch forward, reading x once; one backward, gx = c1*x + c2 per (sample,
  group) from the gradients of a and b.

Statistics: per (sample, group), one pass of mean and mean of squares in
float32, the variance clamped at 0, a = gamma * rstd, b = beta - mean * a.
The plain forward is the eager composition that GroupNorm32 ran, op for
op, so the kernel equals it up to the float32 summation order of the
statistics. The backward is the closed-form gradient of that composition,
float32 inside, gx rounded once; it returns the gradients of gamma, beta, s
and t where they are asked for. `kdip_tpu` leaves its `_FusedGroupNorm`
(kdip_tpu/models/layers.py:40-97) to XLA's fusion: no Pallas kernel
corresponds.

A CUDA tensor goes to the kernels, or the call raises. A CPU (or meta)
tensor runs the plain forward, which autograd differentiates as it did the
eager composition; the closed-form backward's plain version is the card's
reference (and tier-1's check of its algebra).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

_SOURCE = "groupnorm_silu.cu"
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# kernel launches since the last reset_launch_counts(), by kernel name
launch_counts = {"groupnorm_fwd": 0, "groupnorm_stats_fwd": 0,
                 "groupnorm_bwd": 0, "groupnorm_stats_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def _acc(dtype: torch.dtype) -> torch.dtype:
    """The closed-form backward's working type: float32, or float64 for a
    float64 input (tier-1's check of its algebra)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _statistics(x: torch.Tensor, groups: int):
    """(mean, raw variance m2 - mean^2), each [B, G] float32."""
    x32 = x.to(torch.float32).reshape(x.shape[0], groups, -1)
    m = x32.mean(dim=-1)
    m2 = x32.square().mean(dim=-1)
    return m, m2 - m.square()


def _rstd(var: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.rsqrt(var.clamp(min=0.0) + eps)


def _affine(m, var, weight, bias, eps: float):
    """(a, b), each [B, G, C/G] float32, from the statistics."""
    G = m.shape[1]
    a = _rstd(var, eps)[:, :, None] * weight.reshape(G, -1)[None]
    b = bias.reshape(G, -1)[None] - m[:, :, None] * a
    return a, b


def affine_terms_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, groups: int, eps: float):
    """(a, b, stats): a and b [B, C] float32, stats [B, G, 2] (mean, raw
    variance)."""
    B, C = x.shape[:2]
    m, var = _statistics(x, groups)
    a, b = _affine(m, var, weight, bias, eps)
    return a.reshape(B, C), b.reshape(B, C), torch.stack([m, var], -1)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float,
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None,
                     silu: bool = False):
    """(y, stats): y in x's dtype, stats as affine_terms_plain's."""
    a, b, stats = affine_terms_plain(x, weight, bias, groups, eps)
    shape = a.shape + (1,) * (x.ndim - 2)
    y = (x.to(torch.float32) * a.reshape(shape)
         + b.reshape(shape)).to(x.dtype)
    if scale is not None:
        y = y * (1 + scale.reshape(shape)) + shift.reshape(shape)
    if silu:
        y = F.silu(y)
    return y, stats


def _stats_backward(ga, gb, m, var, weight, eps: float, n: int):
    """(c1, c2), each [B, G, 1, 1]: gx = c1 * x + c2 is the gradient through
    the statistics, from ga, gb [B, G, C/G], the gradients of a and b."""
    G = m.shape[1]
    r = _rstd(var, eps)
    gam = weight.to(m.dtype).reshape(G, -1)[None]
    gr = (gam * (ga - m[:, :, None] * gb)).sum(-1)
    gm = -(gb * (r[:, :, None] * gam)).sum(-1)
    gvar = torch.where(var >= 0, -0.5 * gr * r * r * r, torch.zeros_like(gr))
    c1 = 2.0 * gvar / n
    c2 = (gm - 2.0 * m * gvar) / n
    return c1[:, :, None, None], c2[:, :, None, None]


def group_norm_backward_plain(x, gy, weight, bias, stats, groups: int,
                              eps: float, scale=None, shift=None,
                              silu: bool = False):
    """(gx, sums): gx in x's dtype; sums [4, B, C] float32, per (sample,
    channel) the sums of gu*x, gu, gw and gw*u, where u = rnd(x*a + b), gw
    is the gradient at the SiLU's input and gu at u."""
    B, C = x.shape[:2]
    G, dt, acc = groups, x.dtype, _acc(x.dtype)
    x32 = x.to(acc).reshape(B, G, C // G, -1)
    m, var = stats[..., 0], stats[..., 1]
    a, b = _affine(m, var, weight, bias, eps)
    a, b = a[..., None], b[..., None]
    u = (x32 * a + b).to(dt).to(acc)
    w, sp1 = u, None
    if scale is not None:
        sp1 = (1 + scale).to(acc).reshape(B, G, -1, 1)
        t = shift.to(acc).reshape(B, G, -1, 1)
        w = ((u * sp1).to(dt).to(acc) + t).to(dt).to(acc)
    gw = gy.to(acc).reshape(x32.shape)
    if silu:
        sig = torch.sigmoid(w)
        gw = gw * (sig * (1.0 + w * (1.0 - sig)))
    gu = gw if sp1 is None else gw * sp1
    sums = torch.stack([(gu * x32).sum(-1), gu.sum(-1), gw.sum(-1),
                        (gw * u).sum(-1)])
    c1, c2 = _stats_backward(sums[0], sums[1], m, var, weight, eps,
                             x32.shape[2] * x32.shape[3])
    gx = (gu * a + c1 * x32 + c2).to(dt).reshape(x.shape)
    return gx, sums.reshape(4, B, C)


def affine_terms_backward_plain(x, ga, gb, weight, stats, groups: int,
                                eps: float):
    """gx in x's dtype from ga, gb [B, C] float32, the gradients of a, b."""
    B, C = x.shape[:2]
    x32 = x.to(stats.dtype).reshape(B, groups, C // groups, -1)
    c1, c2 = _stats_backward(ga.reshape(B, groups, -1),
                             gb.reshape(B, groups, -1), stats[..., 0],
                             stats[..., 1], weight, eps,
                             x32.shape[2] * x32.shape[3])
    return (c1 * x32 + c2).to(x.dtype).reshape(x.shape)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# The kernels' own limits, which they hold every plan to (kMaxCluster,
# kMaxThreads, kMaxThreadsBwd and kMaxCpg in csrc/groupnorm_silu.cu): the
# portable thread-block cluster size; a CTA's threads, by kernel (the full
# backward holds one CTA an SM, and takes more warps to keep its loads in
# flight); the channels a group, which size the kernels' per-channel tables.
MAX_CLUSTER = 8
MAX_THREADS = {"stats": 512, "fwd": 512, "bwd": 1024}
MAX_CPG = 64
MIN_CTAS = 264         # two CTAs on each of the H100's 132 SMs
MIN_SPLIT_BYTES = 16 * 1024  # a range of a slab worth more CTAs
# packs of a channel a warp takes: 8 rows of 32 lanes (4 in the backward,
# which runs twice the warps)
PACKS_PER_WARP = {"stats": 256, "fwd": 256, "bwd": 128}
# A CTA's cache, by kernel: the forward keeps x (two CTAs an SM), the
# backward x and its float32 gu (one CTA an SM, so that it holds the whole
# range of a 256 px slab of 128 channels); the statistics alone keep none.
CACHE_BYTES = {"stats": 0, "fwd": 104 * 1024, "bwd": 200 * 1024}


class Plan(NamedTuple):
    """What a kernel is launched with: a cluster of `cluster` CTAs per
    (sample, group), each over `span` positions of every channel of the
    group, caching the first `cap` packs of `vec` elements of its range;
    `threads` a CTA."""
    cluster: int
    span: int
    cap: int
    threads: int
    vec: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cached_bytes(kind: str, itemsize: int) -> int:
    """Bytes a kernel caches an element: x, and in the backward gu too."""
    return {"stats": 0, "fwd": itemsize, "bwd": itemsize + 4}[kind]


def launch_plan(B: int, C: int, groups: int, HW: int, itemsize: int,
                kind: str) -> Plan:
    """The launch of kernel `kind` ("stats", "fwd" or "bwd") for x
    [B, C, HW] of `itemsize`-byte elements.

    16-byte packs where each channel's positions allow them. The cluster
    doubles, up to 8 CTAs a (sample, group), while a CTA's range of the
    slab overflows the kernel's cache (MIN_SPLIT_BYTES for the statistics
    alone) or the launch has fewer than MIN_CTAS CTAs, as long as each CTA
    keeps a warp's row of packs of every channel. The cache holds what
    fits of the range; the rest is read twice. Threads: a warp for each
    PACKS_PER_WARP packs of every channel, at most MAX_THREADS[kind]."""
    cpg = C // groups
    vec = 16 // itemsize if HW % (16 // itemsize) == 0 else 1
    slabs, budget = B * groups, CACHE_BYTES[kind]
    per = cached_bytes(kind, itemsize)

    def span(k: int) -> int:
        return _cdiv(_cdiv(HW, k), vec) * vec

    k = 1
    while (k < MAX_CLUSTER and span(2 * k) >= 32 * vec
           and (cpg * span(k) * max(per, itemsize)
                > max(budget, MIN_SPLIT_BYTES) or slabs * k < MIN_CTAS)):
        k *= 2
    packs = span(k) // vec
    cap = min(cpg * packs, budget // (vec * per)) if per else 0
    warps = min(MAX_THREADS[kind] // 32,
                cpg * _cdiv(packs, PACKS_PER_WARP[kind]))
    return Plan(k, span(k), cap, 32 * warps, vec)


def _lib():
    from . import _build
    lib = _build.load(_SOURCE)
    if lib.groupnorm_fwd.argtypes is None:  # pointers must not pass as ints
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.groupnorm_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, i,
                                      i, p, p]
        lib.groupnorm_stats_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f,
                                            i, p, p]
        lib.groupnorm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i,
                                      f, i, i, p, p]
        lib.groupnorm_stats_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f,
                                            i, p, p]
    return lib


def _check(x: torch.Tensor, groups: int, what: str) -> Tuple[int, int, int]:
    if not x.is_cuda:
        raise ValueError(f"{what} takes a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what} takes bfloat16, float16 or float32, got "
                         f"{x.dtype}")
    if x.ndim < 2 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous [B, C, ...] tensor, got "
                         f"{tuple(x.shape)}")
    B, C = x.shape[:2]
    if C % groups or C // groups > MAX_CPG:
        raise ValueError(f"{what}: {C} channels in {groups} groups (at most "
                         f"{MAX_CPG} a group)")
    if B * groups > 65535:
        raise ValueError(f"{what}: B * groups = {B * groups} > 65535")
    return B, C, x.numel() // (B * C)


def _check_same(x: torch.Tensor, shape, dtype, what: str, *ts) -> None:
    for t in ts:
        if (t.shape != shape or t.dtype != dtype or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{what} takes contiguous {dtype} {tuple(shape)} "
                             f"tensors on x's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check_params(x, weight, bias, C, what):
    _check_same(x, (C,), torch.float32, what, weight, bias)


@functools.lru_cache(maxsize=1024)
def _plan_args(B, C, groups, HW, itemsize, kind):
    return (ctypes.c_int * 5)(*launch_plan(B, C, groups, HW, itemsize, kind))


def _plan(B, C, groups, HW, x, kind):
    return _plan_args(B, C, groups, HW, x.element_size(), kind)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launch_counts[name] += 1


def group_norm_cuda(x, weight, bias, groups: int, eps: float, scale=None,
                    shift=None, silu: bool = False):
    """The kernel of group_norm_plain: (y, stats). x contiguous CUDA
    [B, C, ...]; weight, bias float32 [C]; scale, shift [B, C] of x's
    dtype, both or neither."""
    B, C, HW = _check(x, groups, "group_norm_cuda")
    _check_params(x, weight, bias, C, "group_norm_cuda")
    if (scale is None) != (shift is None):
        raise ValueError("pass both the FiLM scale and shift, or neither")
    if scale is not None:
        _check_same(x, (B, C), x.dtype, "the FiLM terms", scale, shift)
    y = torch.empty_like(x)
    stats = torch.empty((B, groups, 2), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.groupnorm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), y.data_ptr(),
            stats.data_ptr(), B, C, groups, HW, eps, int(silu),
            _DTYPES[x.dtype], _plan(B, C, groups, HW, x, "fwd"), _stream(x))
    _raise(err, "groupnorm_fwd")
    return y, stats


def affine_terms_cuda(x, weight, bias, groups: int, eps: float):
    """The kernel of affine_terms_plain: (a, b, stats)."""
    B, C, HW = _check(x, groups, "affine_terms_cuda")
    _check_params(x, weight, bias, C, "affine_terms_cuda")
    a = torch.empty((B, C), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    stats = torch.empty((B, groups, 2), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.groupnorm_stats_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), a.data_ptr(),
            b.data_ptr(), stats.data_ptr(), B, C, groups, HW, eps,
            _DTYPES[x.dtype], _plan(B, C, groups, HW, x, "stats"), _stream(x))
    _raise(err, "groupnorm_stats_fwd")
    return a, b, stats


def group_norm_backward_cuda(x, gy, weight, bias, stats, groups: int,
                             eps: float, scale=None, shift=None,
                             silu: bool = False, want_sums: bool = True):
    """The kernel of group_norm_backward_plain: (gx, sums), sums None
    unless `want_sums`."""
    B, C, HW = _check(x, groups, "group_norm_backward_cuda")
    _check_same(x, x.shape, x.dtype, "the incoming gradient", gy)
    _check_params(x, weight, bias, C, "group_norm_backward_cuda")
    _check_same(x, (B, groups, 2), torch.float32, "stats", stats)
    if (scale is None) != (shift is None):
        raise ValueError("pass both the FiLM scale and shift, or neither")
    if scale is not None:
        _check_same(x, (B, C), x.dtype, "the FiLM terms", scale, shift)
    gx = torch.empty_like(x)
    sums = (torch.empty((4, B, C), dtype=torch.float32, device=x.device)
            if want_sums else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.groupnorm_bwd(
            x.data_ptr(), gy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), stats.data_ptr(),
            gx.data_ptr(), None if sums is None else sums.data_ptr(), B, C,
            groups, HW, eps, int(silu), _DTYPES[x.dtype],
            _plan(B, C, groups, HW, x, "bwd"), _stream(x))
    _raise(err, "groupnorm_bwd")
    return gx, sums


def affine_terms_backward_cuda(x, ga, gb, weight, stats, groups: int,
                               eps: float):
    """The kernel of affine_terms_backward_plain: gx."""
    B, C, HW = _check(x, groups, "affine_terms_backward_cuda")
    _check_same(x, (B, C), torch.float32, "the gradients of a and b", ga, gb)
    _check_same(x, (C,), torch.float32, "affine_terms_backward_cuda", weight)
    _check_same(x, (B, groups, 2), torch.float32, "stats", stats)
    gx = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.groupnorm_stats_bwd(
            x.data_ptr(), ga.data_ptr(), gb.data_ptr(), weight.data_ptr(),
            stats.data_ptr(), gx.data_ptr(), B, C, groups, HW, eps,
            _DTYPES[x.dtype], _plan(B, C, groups, HW, x, "stats"), _stream(x))
    _raise(err, "groupnorm_stats_bwd")
    return gx


# ---------------------------------------------------------------------------
# Autograd: the kernels behind one Function on the card; on the CPU the
# plain forward itself, which autograd differentiates op by op, so that a
# CPU run's numbers are those of the eager composition it replaces
# ---------------------------------------------------------------------------

def param_grads(ga, gb, stats, eps: float):
    """The gradients of gamma and beta, each [C], from ga, gb [B, C], the
    gradients of a and b: sum over the batch of rstd (ga - mean gb), and
    of gb."""
    cpg = ga.shape[1] // stats.shape[1]
    m = stats[..., 0].repeat_interleave(cpg, dim=1)
    r = _rstd(stats[..., 1], eps).repeat_interleave(cpg, dim=1)
    return (r * (ga - m * gb)).sum(0), gb.sum(0)


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, groups, eps, silu):
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        y, stats = group_norm_cuda(x, weight, bias, groups, eps, scale,
                                   shift, silu)
        ctx.save_for_backward(x, weight, bias, scale, shift, stats)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, weight, bias, scale, shift, stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx, sums = group_norm_backward_cuda(
            x, gy.contiguous(), weight, bias, stats, ctx.groups, ctx.eps,
            scale, shift, ctx.silu, want_sums=any(need[1:5]))
        gw = gbias = gs = gt = None
        if need[1] or need[2]:
            gw, gbias = param_grads(sums[0], sums[1], stats, ctx.eps)
        if need[3]:
            gs = sums[3].to(scale.dtype)
        if need[4]:
            gt = sums[2].to(shift.dtype)
        return (gx if need[0] else None, gw, gbias, gs, gt, None, None,
                None)


class _AffineTerms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        ctx.groups, ctx.eps = groups, eps
        a, b, stats = affine_terms_cuda(x, weight, bias, groups, eps)
        ctx.save_for_backward(x, weight, stats)
        return a, b

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ga, gb):
        x, weight, stats = ctx.saved_tensors
        ga, gb = (torch.zeros(x.shape[:2], dtype=torch.float32,
                              device=x.device) if g is None
                  else g.contiguous() for g in (ga, gb))
        gx = gw = gbias = None
        if ctx.needs_input_grad[0]:
            gx = affine_terms_backward_cuda(x, ga, gb, weight, stats,
                                            ctx.groups, ctx.eps)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gw, gbias = param_grads(ga, gb, stats, ctx.eps)
        return gx, gw, gbias, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None,
               silu: bool = False) -> torch.Tensor:
    """Differentiable silu((gn(x) * (1 + scale)) + shift) of x [B, C, ...],
    in x's dtype; scale and shift ([B, C] or [B, C, 1, ...] of x's dtype)
    both or neither, the SiLU where `silu`. gamma and beta (weight, bias
    [C]) are used in float32."""
    if (scale is None) != (shift is None):
        raise ValueError("pass both the FiLM scale and shift, or neither")
    if not x.is_cuda:
        return group_norm_plain(x, weight, bias, groups, eps, scale, shift,
                                silu)[0]
    B, C = x.shape[:2]
    if scale is not None:
        scale, shift = (v.to(x.dtype).reshape(B, C).contiguous()
                        for v in (scale, shift))
    return _GroupNorm.apply(x.contiguous(), _f32(weight), _f32(bias), scale,
                            shift, groups, eps, silu)


def affine_terms(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 groups: int = 32, eps: float = 1e-5):
    """Differentiable (a, b), each [B, C] float32, with gn(x) == x*a + b
    before the rounding."""
    if not x.is_cuda:
        return affine_terms_plain(x, weight, bias, groups, eps)[:2]
    return _AffineTerms.apply(x.contiguous(), _f32(weight), _f32(bias),
                              groups, eps)


def _f32(p: torch.Tensor) -> torch.Tensor:
    return p.to(torch.float32).contiguous()
