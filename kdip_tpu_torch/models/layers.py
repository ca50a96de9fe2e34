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
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.num_groups
        x32 = x.to(torch.float32).reshape(B, G, -1)
        m = x32.mean(dim=-1)
        m2 = x32.square().mean(dim=-1)
        rstd = torch.rsqrt((m2 - m.square()).clamp(min=0.0) + self.eps)
        a = rstd[:, :, None] * self.weight.reshape(G, C // G)[None]
        b = self.bias.reshape(G, C // G)[None] - m[:, :, None] * a
        a = a.reshape(B, C, *([1] * (x.ndim - 2)))
        b = b.reshape(B, C, *([1] * (x.ndim - 2)))
        return (x.to(torch.float32) * a + b).to(x.dtype)


def conv_nd(dims: int, cin: int, cout: int, kernel_size: int, dtype,
            stride: int = 1) -> nn.Module:
    cls = nn.Conv2d if dims == 2 else nn.Conv1d
    return cls(cin, cout, kernel_size, stride=stride,
               padding=kernel_size // 2, dtype=dtype)


class TimestepEmbedSequential(nn.Sequential):
    """Sequential that passes the timestep embedding to its ResBlocks
    (ref: guided_diffusion/unet.py:66-78)."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class ResBlock(nn.Module):
    """ADM residual block with scale-shift (FiLM) timestep-embedding
    conditioning, which every ADM config of this repo uses
    (ref: guided_diffusion/unet.py:143-257, use_scale_shift_norm=True)."""

    def __init__(self, channels: int, emb_channels: int, dtype,
                 out_channels: Optional[int] = None,
                 up: bool = False, down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       conv_nd(2, channels, out_ch, 3, dtype))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_ch, dtype=dtype))
        # index 2 is the reference's Dropout: identity at inference
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(),
                                        nn.Identity(),
                                        conv_nd(2, out_ch, out_ch, 3, dtype))
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
        h = act(norm(x))
        if self.up or self.down:
            h, x = self._resample(h), self._resample(x)
        h = conv(h)
        emb_out = self.emb_layers(emb).to(h.dtype)[:, :, None, None]
        out_norm, out_act, _, out_conv = self.out_layers
        scale, shift = emb_out.chunk(2, dim=1)
        h = out_conv(out_act(out_norm(h) * (1 + scale) + shift))
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
