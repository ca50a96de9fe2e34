"""NN primitives of the ADM UNet (PyTorch port of `kdip_tpu/models/layers.py`).

NCHW layout, and the module names of guided-diffusion's `nn.py`/`unet.py`
(`in_layers.0`, `emb_layers.1`, `skip_connection`, ...), so that a
guided-diffusion state dict loads unchanged.

A module computes in the dtype of its weights. A bfloat16 torso keeps its
GroupNorm parameters and statistics in float32 (GroupNorm32), like the
reference's fp16 torso and `kdip_tpu`'s `_FusedGroupNorm`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import winograd


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings of (possibly fractional) timesteps [N], cos
    first, float32, for an even `dim` (ref: guided_diffusion/nn.py:103-121)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) with float32 statistics and apply, whatever the input
    dtype (ref: guided_diffusion/nn.py:17-19). One-pass mean and
    mean-of-squares, variance clamped at 0, then one `x*a + b` rounded back
    to the input dtype: the arithmetic of `kdip_tpu`'s `_FusedGroupNorm`
    (layers.py:74-92). The weight and bias stay float32 in a low-precision
    torso."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__(num_groups, channels, eps=1e-5)

    def affine_terms(self, x: torch.Tensor):
        """The per-sample, per-channel (a, b), each [B, C] float32, with
        gn(x) == x*a + b before the rounding (`kdip_tpu` _FusedGroupNorm's
        return_affine, layers.py:53-97): what the Winograd kernel's fused
        prologue takes."""
        B, C = x.shape[:2]
        G = self.num_groups
        x32 = x.to(torch.float32).reshape(B, G, -1)
        m = x32.mean(dim=-1)
        m2 = x32.square().mean(dim=-1)
        rstd = torch.rsqrt((m2 - m.square()).clamp(min=0.0) + self.eps)
        a = rstd[:, :, None] * self.weight.reshape(G, C // G)[None]
        b = self.bias.reshape(G, C // G)[None] - m[:, :, None] * a
        return a.reshape(B, C), b.reshape(B, C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.affine_terms(x)
        shape = a.shape + (1,) * (x.ndim - 2)
        return (x.to(torch.float32) * a.reshape(shape)
                + b.reshape(shape)).to(x.dtype)


def conv_nd(dims: int, cin: int, cout: int, kernel_size: int, dtype,
            stride: int = 1) -> nn.Module:
    cls = nn.Conv2d if dims == 2 else nn.Conv1d
    return cls(cin, cout, kernel_size, stride=stride,
               padding=kernel_size // 2, dtype=dtype)


class Conv2d(nn.Conv2d):
    """A same-padded nn.Conv2d (the same `weight` and `bias`) whose forward
    takes an optional prologue (a, b), [B, Cin] float32: it convolves
    silu(x*a + b) (`kdip_tpu` SplitSkipConv, layers.py:126-207).

    With `winograd` set, an eligible call (3x3, stride 1, even H and W, a
    bfloat16 or float16 weight; layers.py:171-173) runs
    `ops.winograd.winograd_conv3x3`, the prologue fused into its input
    load. Any other call takes the direct conv and applies the prologue
    unfused. The weight's two Winograd transforms are cached, keyed on the
    weight's storage and version counter. `conv_fn`, where set, replaces
    the kernel's device dispatch (a comparison's plain version)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dtype,
                 winograd: bool = False):
        super().__init__(cin, cout, kernel_size, padding=kernel_size // 2,
                         dtype=dtype)
        self.winograd = winograd
        self.conv_fn = None
        self._transforms = (None, None)

    def _eligible(self, x: torch.Tensor) -> bool:
        return (self.winograd and self.kernel_size == (3, 3)
                and self.stride == (1, 1)
                and self.weight.dtype in (torch.bfloat16, torch.float16)
                and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0)

    def _winograd_transforms(self):
        w = self.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._transforms[0] != key:
            with torch.no_grad():
                self._transforms = (key, (
                    winograd.kernel_transform(w),
                    winograd.kernel_transform(winograd.rotated_weight(w))))
        return self._transforms[1]

    def forward(self, x: torch.Tensor, prologue=None) -> torch.Tensor:
        if self._eligible(x):
            return winograd.winograd_conv3x3(
                x, self.weight, self.bias, prologue,
                transforms=self._winograd_transforms(), conv=self.conv_fn)
        if prologue is not None:
            x = winograd.affine_silu(x.to(self.weight.dtype), *prologue)
        return super().forward(x)


class Upsample(nn.Module):
    """2x nearest-neighbour upsample, then a 3x3 conv where `use_conv`
    (ref: guided_diffusion/unet.py:81-110; `kdip_tpu` layers.py:227-242).
    The conv is the direct one: `kdip_tpu` routes only the ResBlocks'
    convs through Winograd."""

    def __init__(self, channels: int, use_conv: bool, dtype,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = conv_nd(2, channels, out_channels or channels, 3,
                                dtype)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if self.use_conv else x


class Downsample(nn.Module):
    """2x downsample: a stride-2 3x3 conv where `use_conv`, else a 2x2
    average pool (ref: guided_diffusion/unet.py:113-140; `kdip_tpu`
    layers.py:245-262). The module is named `op` either way, as in the
    reference (the pool holds no weights)."""

    def __init__(self, channels: int, use_conv: bool, dtype,
                 out_channels: Optional[int] = None):
        super().__init__()
        out_ch = out_channels or channels
        if use_conv:
            self.op = conv_nd(2, channels, out_ch, 3, dtype, stride=2)
        else:
            if out_ch != channels:
                raise ValueError("the average-pool downsample keeps the "
                                 "channel count")
            self.op = nn.AvgPool2d(2)

    def forward(self, x):
        return self.op(x)


class Dropout(nn.Module):
    """Dropout at rate p under train(), the identity under eval() or at
    p = 0, as flax's nn.Dropout computes it (`kdip_tpu`'s ResBlock and
    k-diffusion blocks): each value kept with probability 1 - p, a kept
    value divided by 1 - p in x's dtype, the rest 0. The keep mask is
    drawn from `generator` where one is set (`set_dropout_generator`),
    else from torch's default generator on x's device. With `shard` =
    (rank, world) x is a rank's block of a batch split over world ranks:
    the mask is drawn for the whole batch and the block kept, so the ranks
    together drop what one process would."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate {p} is not in [0, 1)")
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[Tuple[int, int]] = None

    @property
    def live(self) -> bool:
        return self.training and self.p > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.live:
            return x
        (r, w), n = self.shard or (0, 1), x.shape[0]
        keep = torch.rand((n * w,) + x.shape[1:], generator=self.generator,
                          device=x.device)[r * n:(r + 1) * n] < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator],
                          shard: Optional[Tuple[int, int]] = None) -> None:
    """Draws every Dropout mask of `model` from `generator` (None: torch's
    default generator), for a rank's block of a batch split over ranks
    where `shard` = (rank, world) is given. Two models of one
    architecture, each given a generator seeded alike, draw the same masks
    in the same forward."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            m.shard = shard


class TimestepEmbedSequential(nn.Sequential):
    """Sequential that passes the timestep embedding to its ResBlocks
    (ref: guided_diffusion/unet.py:66-78)."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class ResBlock(nn.Module):
    """ADM residual block with timestep-embedding conditioning
    (ref: guided_diffusion/unet.py:143-257): scale-shift (FiLM) norm by
    default, which every ADM config of this repo uses; with
    `use_scale_shift_norm=False` the embedding is added to h before
    out_layers.

    `dropout` (out_layers[2]) is live under train() and the identity under
    eval(), as `kdip_tpu`'s `deterministic` flag sets it.

    `winograd` (`kdip_tpu` layers.py:263-381) takes effect in a bfloat16 or
    float16 torso, checked at forward time: its two 3x3 convs run the
    Winograd kernel, with GroupNorm + SiLU fused into their input load
    where no dropout is live (layers.py:311-313); under live dropout both
    run the plain kernel on the unfused path.
    in_conv fuses in every block that does not downsample (an up-block
    takes the affine from x before the nearest upsample, which commutes
    with the pointwise prologue); a down-block runs the plain kernel on the
    pooled, activated h. out_conv fuses always, the FiLM scale and shift
    absorbed into the affine: gn(h)*(1+s) + t = h*(a*(1+s)) + (b*(1+s) + t);
    without scale-shift its affine is the statistics of h + emb
    (`kdip_tpu` layers.py:357-363). A float32 torso keeps the direct path
    whatever the flag."""

    def __init__(self, channels: int, emb_channels: int, dtype,
                 out_channels: Optional[int] = None,
                 up: bool = False, down: bool = False,
                 winograd: bool = False,
                 use_scale_shift_norm: bool = True, dropout: float = 0.0):
        super().__init__()
        out_ch = out_channels or channels
        self.up, self.down = up, down
        self.winograd = winograd
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            Conv2d(channels, out_ch, 3, dtype, winograd))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, (
                2 * out_ch if use_scale_shift_norm else out_ch), dtype=dtype))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch), nn.SiLU(), Dropout(dropout),
            Conv2d(out_ch, out_ch, 3, dtype, winograd))
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = conv_nd(2, channels, out_ch, 1, dtype)

    def _resample(self, h):
        if self.up:
            return F.interpolate(h, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(h, 2)
        return h

    def forward(self, x, emb):
        norm, act, conv = self.in_layers
        out_norm, out_act, drop, out_conv = self.out_layers
        if (self.winograd and not drop.live
                and conv.weight.dtype in (torch.bfloat16, torch.float16)):
            return self._forward_fused(x, emb)
        h = act(norm(x))
        if self.up or self.down:
            h, x = self._resample(h), self._resample(x)
        h = conv(h)
        emb_out = self.emb_layers(emb).to(h.dtype)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = out_conv(drop(out_act(out_norm(h) * (1 + scale) + shift)))
        else:
            h = out_conv(drop(out_act(out_norm(h + emb_out))))
        return self.skip_connection(x) + h

    def _forward_fused(self, x, emb):
        norm, act, conv = self.in_layers
        out_norm, _, _, out_conv = self.out_layers
        if self.down:
            h = self._resample(act(norm(x)))
            x = self._resample(x)
            h = conv(h)
        else:
            aff = norm.affine_terms(x)
            x = self._resample(x)
            h = conv(x, prologue=aff)
        emb_out = self.emb_layers(emb).to(h.dtype)
        if not self.use_scale_shift_norm:
            h = h + emb_out[:, :, None, None]
            return self.skip_connection(x) + out_conv(
                h, prologue=out_norm.affine_terms(h))
        s, t = (v.to(torch.float32) for v in emb_out.chunk(2, dim=1))
        a, b = out_norm.affine_terms(h)
        h = out_conv(h, prologue=(a * (1 + s), b * (1 + s) + t))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over flattened positions
    (ref: guided_diffusion/unet.py:260-395). Both head-split orders: legacy
    (heads split before q/k/v, which FFHQ uses) and new. Logits accumulate
    and softmax in float32, as in `kdip_tpu` (layers.py:423-431)."""

    def __init__(self, channels: int, dtype, num_heads: int = 1,
                 num_head_channels: int = -1,
                 use_new_attention_order: bool = False):
        super().__init__()
        if num_head_channels == -1:
            self.num_heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"channels {channels} not divisible by "
                                 f"num_head_channels {num_head_channels}")
            self.num_heads = channels // num_head_channels
        self.use_new_attention_order = use_new_attention_order
        self.norm = GroupNorm32(channels)
        self.qkv = conv_nd(1, channels, 3 * channels, 1, dtype)
        self.proj_out = conv_nd(1, channels, channels, 1, dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        heads, ch, T = self.num_heads, C // self.num_heads, H * W
        h = x.reshape(B, C, T)
        qkv = self.qkv(self.norm(h))  # [B, 3C, T]
        if self.use_new_attention_order:
            q, k, v = (t.reshape(B * heads, ch, T) for t in qkv.chunk(3, dim=1))
        else:
            q, k, v = qkv.reshape(B * heads, 3 * ch, T).split(ch, dim=1)
        scale = 1 / math.sqrt(math.sqrt(ch))
        logits = torch.einsum("bct,bcs->bts", (q * scale).to(torch.float32),
                              (k * scale).to(torch.float32))
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        a = torch.einsum("bts,bcs->bct", weights, v).reshape(B, C, T)
        return (h + self.proj_out(a)).reshape(B, C, H, W).to(x.dtype)
