"""Winograd F(2x2, 3x3) convolution on NCHW tensors: the hand-written CUDA
kernel (csrc/winograd_f23.cu), its plain PyTorch version, and the autograd
pair that the ResBlocks of a `winograd=True` ADM torso run.

Port of `kdip_tpu/ops/experimental/winograd_pallas.py` (`_wino_kernel`, its
plain and `prologue=True` forms, and their custom VJPs) and of
`kdip_tpu/ops/experimental/winograd.py` (`kernel_transform`, the composite
`winograd_conv3x3_jnp` over channel parts, and its `impl` dispatcher:
`winograd_conv3x3_parts` here). A
stride-1, same-padded 3x3 conv is computed per 2x2 output tile as
Y = A^T [(G g G^T) . (B^T d B)] A:

- `kernel_transform`: V[16, C, F] = G g G^T, in float32 from the weight,
  rounded once to the torso dtype;
- the input transform B^T d B: adds in the input dtype, rounded after each
  of its two stages (rows, then columns), as the Pallas kernel does;
- 16 products U_p [N, C] @ V_p [C, F] accumulated in float32;
- the output transform A^T M A: float32 adds in the Pallas kernel's order,
  rounded once to the input dtype.

With a prologue (a, b), each [B, C] float32 from GroupNorm32.affine, the
conv runs on silu(x*a + b): the affine in float32, rounded to the input
dtype, SiLU in float32, rounded again. The conv's zero padding stays zero
after the prologue (silu(b) != 0).

One difference from `kdip_tpu`: its `_forward` cuts C and F into chunks of
at most 128 (the TPU's VMEM and 128x128 matrix unit) and sums the chunks'
outputs in the torso dtype; here the whole of C accumulates in float32 and
rounds once (tests/test_torch_winograd_ops.py: test_bf16_chunked_sum_departure
records the difference).

A CUDA tensor goes to the kernel, or the call raises; a CPU tensor goes to
the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

_SOURCE = "winograd_f23.cu"
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}  # the kernel's dtype codes

# kernel launches since the last reset_launch_counts(), by kernel name
launch_counts = {"winograd_conv3x3": 0, "winograd_conv3x3_fused": 0}

Prologue = Optional[Tuple[torch.Tensor, torch.Tensor]]

# F(2x2, 3x3), interpolation points {0, +-1, inf}
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def kernel_transform(w: torch.Tensor, dtype=None) -> torch.Tensor:
    """OIHW weight [F, C, 3, 3] -> V [16, C, F] = G g G^T, computed in
    float32 and rounded once to `dtype` (default: w's dtype)."""
    g = torch.tensor(_G, dtype=torch.float32, device=w.device)
    v = torch.einsum("ik,fckl,jl->ijcf", g, w.to(torch.float32), g)
    return v.reshape(16, w.shape[1], w.shape[0]).to(dtype or w.dtype)


def rotated_weight(w: torch.Tensor) -> torch.Tensor:
    """The weight whose conv is the input gradient of w's conv: spatially
    flipped, in and out channels swapped."""
    return w.flip(2, 3).transpose(0, 1)


def affine_silu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """silu(x*a + b) with the prologue's roundings: the affine in float32,
    rounded to x's dtype, SiLU in float32, rounded again
    (`winograd_pallas._affine_silu` and the kernel's :116-123)."""
    t = (x.to(torch.float32) * a[:, :, None, None]
         + b[:, :, None, None]).to(x.dtype)
    return F.silu(t.to(torch.float32)).to(x.dtype)


def _input_transform(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> U [16, B*th*tw, C] in x's dtype: B^T d B of every 4x4
    patch at stride 2 of the zero-padded x, each add rounded to the dtype."""
    B, C, H, W = x.shape
    th, tw = H // 2, W // 2
    xp = F.pad(x, (1, 1, 1, 1))
    d = [[xp[:, :, i:i + 2 * th:2, j:j + 2 * tw:2] for j in range(4)]
         for i in range(4)]
    rows = [[d[0][j] - d[2][j] for j in range(4)],
            [d[1][j] + d[2][j] for j in range(4)],
            [d[2][j] - d[1][j] for j in range(4)],
            [d[1][j] - d[3][j] for j in range(4)]]
    u = []
    for r in rows:
        u += [r[0] - r[2], r[1] + r[2], r[2] - r[1], r[1] - r[3]]
    return torch.stack(u).permute(0, 1, 3, 4, 2).reshape(16, -1, C)


def _output_transform(m):
    """The four outputs of each tile from the 16 products m[i*4+j], float32
    adds in the Pallas kernel's order (i outer, j inner)."""
    def acc(terms):
        out = None
        for sign, p in terms:
            out = (m[p] if sign > 0 else -m[p]) if out is None else (
                out + m[p] if sign > 0 else out - m[p])
        return out
    a_t = ((1, 1, 1, 0), (0, 1, -1, -1))  # A^T
    return [[acc([(a_t[k][i] * a_t[l][j], i * 4 + j)
                  for i in range(4) for j in range(4)
                  if a_t[k][i] * a_t[l][j]])
             for l in range(2)] for k in range(2)]


def winograd_conv3x3_plain(x: torch.Tensor, v: torch.Tensor,
                           prologue: Prologue = None) -> torch.Tensor:
    """The conv of NCHW x [B, C, H, W] (H, W even) with V [16, C, F] from
    kernel_transform, with the kernel's roundings; y [B, F, H, W] in x's
    dtype, no bias. The products of two bf16 (or fp16) values are exact in
    float32, so float32 products accumulate as the kernel's tensor cores
    do, in another order."""
    if prologue is not None:
        x = affine_silu(x, *prologue)
    B, C, H, W = x.shape
    th, tw = H // 2, W // 2
    u = _input_transform(x)
    m = torch.matmul(u.to(torch.float32), v.to(torch.float32))  # [16, N, F]
    y = _output_transform(m.reshape(16, B, th, tw, -1))
    # y[k][l][b, t, s, f] -> out[b, f, 2t+k, 2s+l]
    y = torch.stack([torch.stack(row, 3) for row in y], 2)  # [B,th,2,tw,2,F]
    return y.permute(0, 5, 1, 2, 3, 4).reshape(B, -1, H, W).to(x.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

# The kernel's two tilings, (TH, TW, FB, US) of TilingL and TilingT in
# csrc/winograd_f23.cu: a CTA owns TH x TW output tiles, FB output channels
# at a time, and holds the input transform of US input channels. _kernels()
# holds this table to the library's.
TILINGS = ((8, 8, 32, 64), (4, 4, 64, 64))
MIN_CTAS = 64      # CTAs a launch aims at (see launch_config)
MAX_CLUSTER = 8    # the portable thread-block cluster size: the C split


class LaunchConfig(NamedTuple):
    """What the kernel is launched with: the grid is csplit * fgroups CTAs
    along x (a cluster of csplit along C), the tile blocks along y and the
    samples along z."""
    tiling: int   # index into TILINGS
    csplit: int   # CTAs along C, one cluster
    cs: int       # input channels of a CTA's slice, a multiple of 16
    fgroups: int  # groups of F blocks, none empty
    fper: int     # F blocks of FB channels a group


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_config(B: int, C: int, F: int, H: int, W: int) -> LaunchConfig:
    """The launch of a conv of x [B, C, H, W] into F channels.

    The tiling: 8x8 tiles x 32 output channels wherever the image has 8x8
    tiles, else 4x4 tiles x 64. The C split is the least that lets U hold
    a CTA's slice of C whole. Then, until the launch has MIN_CTAS CTAs,
    more CTAs along C while each slice keeps two chunks of 16 channels,
    then along F, then along C down to one chunk. Where U cannot hold a
    slice it is rebuilt for every F block, so each CTA takes one F block.
    Either tiling keeps one CTA on an SM, so 64 to 132 CTAs run in one
    wave, and a CTA that keeps its input transform over more output
    channels and more input channels spends less of its time on the
    transform and the cross-CTA sum: on the H100 that beat filling all 132
    SMs with thinner CTAs (PERF.md)."""
    th, tw = H // 2, W // 2
    chunks = _cdiv(C, 16)
    tiling = 0 if min(th, tw) >= TILINGS[0][0] else 1
    TH, TW, FB, US = TILINGS[tiling]
    blocks, nfb = B * _cdiv(th, TH) * _cdiv(tw, TW), _cdiv(F, FB)
    split = 1
    while split < min(MAX_CLUSTER, chunks) and _cdiv(chunks, split) > US // 16:
        split *= 2
    groups = 1
    while blocks * split * groups < MIN_CTAS:
        if split < MAX_CLUSTER and _cdiv(chunks, 2 * split) >= 2:
            split *= 2
        elif groups < nfb:
            groups = min(nfb, 2 * groups)
        elif split < min(MAX_CLUSTER, chunks):
            split *= 2
        else:
            break
    if _cdiv(chunks, split) > US // 16:
        groups = nfb
    fper = _cdiv(nfb, groups)
    return LaunchConfig(tiling, split, 16 * _cdiv(chunks, split),
                        _cdiv(nfb, fper), fper)


def _kernels():
    from . import _build
    lib = _build.load(_SOURCE)
    plain, fused = lib.winograd_f23_conv, lib.winograd_f23_conv_fused
    if plain.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i, cfg = ctypes.c_void_p, ctypes.c_int, ctypes.c_int * 5
        plain.argtypes = [p, p, p, i, i, i, i, i, i, cfg, p]
        fused.argtypes = [p, p, p, p, p, i, i, i, i, i, i, cfg, p]
        plain.restype = fused.restype = ctypes.c_int
        for tiling, want in enumerate(TILINGS):
            got = (ctypes.c_int * 4)()
            if lib.winograd_f23_tiling(tiling, got) != 0 or \
                    tuple(got) != want:
                raise RuntimeError(f"tiling {tiling}: the kernel has "
                                   f"{tuple(got)}, TILINGS {want}")
    return plain, fused


def winograd_conv3x3_cuda(x: torch.Tensor, v: torch.Tensor,
                          prologue: Prologue = None) -> torch.Tensor:
    """Launches the kernel on the current stream: x [B, C, H, W] and
    V [16, C, F], contiguous CUDA tensors of one dtype, bfloat16 or float16;
    with prologue, a and b [B, C] float32. Returns y [B, F, H, W]."""
    if not x.is_cuda:
        raise ValueError("winograd_conv3x3_cuda takes a CUDA tensor")
    if x.dtype not in _DTYPES or v.dtype != x.dtype:
        raise ValueError(f"the kernel takes bfloat16 or float16 x and V of "
                         f"one dtype, got {x.dtype} and {v.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected NCHW x, got {tuple(x.shape)}")
    B, C, H, W = x.shape
    if v.ndim != 3 or v.shape[:2] != (16, C):
        raise ValueError(f"V {tuple(v.shape)} does not match C={C}")
    if H % 2 or W % 2:
        raise ValueError(f"H, W = {H}, {W} must be even")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("winograd_conv3x3_cuda takes contiguous tensors")
    if v.device != x.device:
        raise ValueError("x and V must be on one device")
    Fo = v.shape[2]
    plain, fused = _kernels()
    config = (ctypes.c_int * 5)(*launch_config(B, C, Fo, H, W))
    y = torch.empty((B, Fo, H, W), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if prologue is None:
            err = plain(x.data_ptr(), v.data_ptr(), y.data_ptr(),
                        B, C, Fo, H, W, _DTYPES[x.dtype], config, stream)
        else:
            a, b = prologue
            for t in (a, b):
                if (t.shape != (B, C) or t.dtype != torch.float32
                        or not t.is_contiguous() or t.device != x.device):
                    raise ValueError(f"the prologue takes contiguous float32 "
                                     f"[{B}, {C}] tensors on x's device, got "
                                     f"{t.dtype} {tuple(t.shape)}")
            err = fused(x.data_ptr(), v.data_ptr(), a.data_ptr(),
                        b.data_ptr(), y.data_ptr(), B, C, Fo, H, W,
                        _DTYPES[x.dtype], config, stream)
    if err != 0:
        raise RuntimeError(f"winograd_f23 launch failed: cudaError {err}")
    launch_counts["winograd_conv3x3" if prologue is None
                  else "winograd_conv3x3_fused"] += 1
    return y


def _run(x: torch.Tensor, v: torch.Tensor, prologue: Prologue = None):
    if x.is_cuda:
        return winograd_conv3x3_cuda(x, v, prologue)
    return winograd_conv3x3_plain(x, v, prologue)


# ---------------------------------------------------------------------------
# Autograd: dx is the same conv on the rotated weight (`_wino_bwd`,
# `_wino_fused_bwd`); dW, which guided sampling never asks for, is
# conv2d_weight, as kdip_tpu leaves it to an XLA conv.
# ---------------------------------------------------------------------------

class _WinogradConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, v, v_rot, conv):
        ctx.conv = conv
        ctx.save_for_backward(x, weight, v_rot)
        return conv(x, v)

    @staticmethod
    def backward(ctx, g):
        x, weight, v_rot = ctx.saved_tensors
        g = g.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = ctx.conv(g, v_rot).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(
                x, weight.shape, g.to(x.dtype), padding=1).to(weight.dtype)
        return gx, gw, None, None, None


class _WinogradConvFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, weight, v, v_rot, conv):
        ctx.conv = conv
        ctx.save_for_backward(x, a, b, weight, v_rot)
        return conv(x, v, (a, b))

    @staticmethod
    def backward(ctx, g):
        x, a, b, weight, v_rot = ctx.saved_tensors
        g = g.contiguous()
        gx = ga = gb = gw = None
        if any(ctx.needs_input_grad[:3]):
            # cotangent of s = silu(t), then the float32 dsilu chain
            gs = ctx.conv(g, v_rot)
            x32 = x.to(torch.float32)
            av, bv = a[:, :, None, None], b[:, :, None, None]
            t = x32 * av + bv
            sig = torch.sigmoid(t)
            dt = gs.to(torch.float32) * (sig * (1.0 + t * (1.0 - sig)))
            gx = (dt * av).to(x.dtype)
            ga = (dt * x32).sum((2, 3)).to(a.dtype)
            gb = dt.sum((2, 3)).to(b.dtype)
        if ctx.needs_input_grad[3]:
            gw = torch.nn.grad.conv2d_weight(
                affine_silu(x, a, b), weight.shape, g.to(x.dtype),
                padding=1).to(weight.dtype)
        return gx, ga, gb, gw, None, None, None


def winograd_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     prologue: Prologue = None,
                     transforms: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None,
                     conv: Optional[Callable] = None) -> torch.Tensor:
    """Differentiable 3x3, stride-1, same-padded conv of NCHW x in the
    weight's dtype, by Winograd F(2,3); H and W even. prologue=(a, b)
    ([B, C] float32) convolves silu(x*a + b) instead, fused into the
    kernel's input load. The bias is added after the rounding, in the
    torso dtype. `transforms` = (V, V_rot), kernel_transform of the weight
    and of its rotation, may be cached by the caller (sampling never
    changes the weights). `conv` replaces the device dispatch (a test's or
    a comparison's plain version)."""
    x = x.to(weight.dtype).contiguous()
    if transforms is None:
        with torch.no_grad():
            transforms = (kernel_transform(weight),
                          kernel_transform(rotated_weight(weight)))
    v, v_rot = transforms
    conv = conv or _run
    if prologue is None:
        y = _WinogradConv.apply(x, weight, v, v_rot, conv)
    else:
        a, b = (t.to(torch.float32).contiguous() for t in prologue)
        y = _WinogradConvFused.apply(x, a, b, weight, v, v_rot, conv)
    if bias is not None:
        y = y + bias.to(y.dtype)[:, None, None]
    return y


# ---------------------------------------------------------------------------
# The composite conv over channel parts, and its `impl` dispatcher
# (`kdip_tpu/ops/experimental/winograd.py:96-155`)
# ---------------------------------------------------------------------------

WINOGRAD_IMPLS = ("cuda", "plain")


def winograd_conv3x3_parts(x, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           dtype=None, impl: str = "cuda",
                           prologue: Prologue = None) -> torch.Tensor:
    """The 3x3 stride-1 same-padded conv by Winograd F(2,3), no autograd,
    of NCHW x [B, C, H, W] (H, W even) or of a tuple of channel parts
    whose channels sum to the weight's C (`kdip_tpu`'s split-skip input).
    weight [F, C, 3, 3]; the conv runs in `dtype` (default: the first
    part's), the result is cast back to the first part's dtype and the
    bias added in it. prologue=(a, b), [B, C] float32, convolves
    silu(x*a + b).

    The parts are concatenated along C: the float32 accumulation over C
    is their sum in transform space. impl "cuda" launches the kernel
    (bfloat16 or float16, CUDA tensors; anything else raises), impl
    "plain" runs the plain PyTorch version on any device. Any other impl
    raises."""
    if impl not in WINOGRAD_IMPLS:
        raise ValueError(f"impl must be one of {WINOGRAD_IMPLS}, got "
                         f"{impl!r}")
    parts = x if isinstance(x, tuple) else (x,)
    out_dtype = parts[0].dtype
    dtype = dtype or out_dtype
    xc = torch.cat([p.to(dtype) for p in parts], 1).contiguous()
    pro = None if prologue is None else tuple(
        t.to(torch.float32).contiguous() for t in prologue)
    conv = winograd_conv3x3_cuda if impl == "cuda" else winograd_conv3x3_plain
    y = conv(xc, kernel_transform(weight, dtype), pro)
    y = y.to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)[:, None, None]
    return y
