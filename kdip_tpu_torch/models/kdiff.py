"""The k-diffusion native UNets, ImageDenoiserModelV1 and V2 (PyTorch port
of `kdip_tpu/models/kdiff.py`; ref: k_diffusion/models/image_v1.py,
image_v2.py and k_diffusion/layers.py:89-284).

AdaGN conditioning, Fourier sigma features, FIR up- and downsampling,
pixel (un)shuffle patching and the variance outputs of the DCT/DWT-Var
models: V2 returns (x0, logvar, logvar_ot), V1 (x0, logvar) with one
scalar logvar per image.

NCHW layout, float32 whatever the torso dtype elsewhere (`kdip_tpu`'s
config.make_model passes these models no dtype). Module and parameter
names are k-diffusion's (`timestep_embed`, `mapping_cond`, `mapping.{0,2}`,
`proj_in`, `proj_out`, `u_net.d_blocks.{i}.{j}`, `u_net.u_blocks.{k}.{j}`
with the up blocks stored in reverse level order), so a k-diffusion state
dict loads strictly, its FIR `kernel` buffers included. As in
k-diffusion, every level's down and up block is built, those below
`skip_stages` too, and the forward skips them.

One departure from k-diffusion, to follow `kdip_tpu`: CrossAttention2d's
LayerNorm has flax's epsilon, 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dropout

FIR_KERNELS = {
    "linear": [1 / 8, 3 / 8, 3 / 8, 1 / 8],
    "cubic": [-0.01171875, -0.03515625, 0.11328125, 0.43359375,
              0.43359375, 0.11328125, -0.03515625, -0.01171875],
}


def fir_kernel_2d(name: str = "linear", scale: float = 1.0) -> torch.Tensor:
    """The separable FIR kernel k^T k of `name`, float32, each 1-D tap
    times `scale` (2 for the upsample)."""
    k = torch.tensor([FIR_KERNELS[name]], dtype=torch.float32) * scale
    return k.T @ k


class FourierFeatures(nn.Module):
    """Random Fourier features (ref: k_diffusion/layers.py:257-265): a fixed
    `weight` buffer [out/2, in], N(0, std^2)."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 1.0):
        super().__init__()
        if out_features % 2:
            raise ValueError("out_features must be even")
        self.register_buffer("weight", torch.randn(
            out_features // 2, in_features) * std)

    def forward(self, x):
        f = 2 * math.pi * x @ self.weight.T
        return torch.cat([f.cos(), f.sin()], dim=-1)


class AdaGN(nn.Module):
    """Adaptive GroupNorm (ref: k_diffusion/layers.py:135-146):
    group_norm(x) * (1 + W c) + b c, the norm without affine, eps 1e-5."""

    def __init__(self, feats_in: int, c_out: int, num_groups: int,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.mapper = nn.Linear(feats_in, c_out * 2)

    def forward(self, x, cond):
        weight, bias = self.mapper(cond).chunk(2, dim=-1)
        x = F.group_norm(x, self.num_groups, eps=self.eps)
        return x * (weight[:, :, None, None] + 1) + bias[:, :, None, None]


def _attention(q, k, v, dropout: Dropout, padding=None):
    """dropout(softmax((q s)(k s)^T)) v over the last two axes, s = head
    size^-0.25, the logits and softmax in float32 (`kdip_tpu` kdiff.py:
    73-79); q [B, h, T, c], k and v [B, h, S, c]; padding [B, S], 1 where
    a key is padding (an additive -1e4)."""
    scale = k.shape[-1] ** -0.25
    att = (q * scale).float() @ (k * scale).float().transpose(-1, -2)
    if padding is not None:
        att = att - padding[:, None, None, :].float() * 10000
    return dropout(att.softmax(-1).to(v.dtype)) @ v


class SelfAttention2d(nn.Module):
    """(ref: k_diffusion/layers.py:151-170)"""

    def __init__(self, c_in: int, n_head: int, norm_groups: int,
                 feats_in: int, dropout_rate: float = 0.0):
        super().__init__()
        if c_in % n_head:
            raise ValueError(f"{c_in} channels in {n_head} heads")
        self.norm_in = AdaGN(feats_in, c_in, norm_groups)
        self.n_head = n_head
        self.qkv_proj = nn.Conv2d(c_in, c_in * 3, 1)
        self.out_proj = nn.Conv2d(c_in, c_in, 1)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, cond):
        n, c, h, w = x.shape
        qkv = self.qkv_proj(self.norm_in(x, cond))
        qkv = qkv.view(n, self.n_head * 3, c // self.n_head,
                       h * w).transpose(2, 3)
        q, k, v = qkv.chunk(3, dim=1)
        y = _attention(q, k, v, self.dropout).transpose(2, 3).reshape(
            n, c, h, w)
        return x + self.out_proj(y)


class CrossAttention2d(nn.Module):
    """Cross-attention from 2-D features to an encoder sequence
    (ref: k_diffusion/layers.py:173-202): queries from AdaGN-normalised
    pixels, keys and values from the LayerNorm'd sequence [B, S, c_enc],
    and padded positions (`cross_padding` [B, S], 1 for padding) masked by
    an additive -1e4."""

    def __init__(self, c_dec: int, c_enc: int, n_head: int,
                 norm_groups: int, feats_in: int, dropout_rate: float = 0.0):
        super().__init__()
        self.norm_enc = nn.LayerNorm(c_enc, eps=1e-6)
        self.norm_dec = AdaGN(feats_in, c_dec, norm_groups)
        self.n_head = n_head
        self.q_proj = nn.Conv2d(c_dec, c_dec, 1)
        self.kv_proj = nn.Linear(c_enc, c_dec * 2)
        self.out_proj = nn.Conv2d(c_dec, c_dec, 1)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, cond, cross, cross_padding):
        n, c, h, w = x.shape
        q = self.q_proj(self.norm_dec(x, cond))
        q = q.view(n, self.n_head, c // self.n_head, h * w).transpose(2, 3)
        kv = self.kv_proj(self.norm_enc(cross))
        kv = kv.view(n, -1, self.n_head * 2, c // self.n_head).transpose(1, 2)
        k, v = kv.chunk(2, dim=1)
        y = _attention(q, k, v, self.dropout, cross_padding).transpose(2, 3)
        return x + self.out_proj(y.reshape(n, c, h, w))


class Downsample2d(nn.Module):
    """FIR antialiased 2x downsample (ref: k_diffusion/layers.py:223-236):
    reflect pad, then a stride-2 conv of each channel with the fixed
    `kernel` buffer (k-diffusion's dense diagonal weight, as a depthwise
    conv)."""

    def __init__(self, kernel: str = "linear"):
        super().__init__()
        self.register_buffer("kernel", fir_kernel_2d(kernel))
        self.pad = self.kernel.shape[0] // 2 - 1

    def forward(self, x):
        x = F.pad(x, (self.pad,) * 4, mode="reflect")
        c = x.shape[1]
        w = self.kernel.to(x.dtype)[None, None].expand(c, 1, -1, -1)
        return F.conv2d(x, w, stride=2, groups=c)


class Upsample2d(nn.Module):
    """FIR 2x upsample (ref: k_diffusion/layers.py:239-252): reflect pad,
    then a stride-2 transposed conv of each channel with the fixed
    `kernel` buffer (taps times 2)."""

    def __init__(self, kernel: str = "linear"):
        super().__init__()
        self.register_buffer("kernel", fir_kernel_2d(kernel, 2.0))
        self.pad = self.kernel.shape[0] // 2 - 1

    def forward(self, x):
        x = F.pad(x, ((self.pad + 1) // 2,) * 4, mode="reflect")
        c = x.shape[1]
        w = self.kernel.to(x.dtype)[None, None].expand(c, 1, -1, -1)
        return F.conv_transpose2d(x, w, stride=2, padding=self.pad * 2 + 1,
                                  groups=c)


class ResConvBlock(nn.Module):
    """(ref: k_diffusion/models/image_v2.py:16-28): AdaGN, exact GELU, 3x3
    conv, twice (`main.{0,2,4,6}` the norms and convs, the GELUs at 1 and
    5, the dropouts at 3 and 7, live under train()), plus the input,
    through a bias-free 1x1 `skip` where the channel count changes."""

    def __init__(self, feats_in: int, c_in: int, c_mid: int, c_out: int,
                 group_size: int = 32, dropout_rate: float = 0.0):
        super().__init__()
        self.main = nn.Sequential(
            AdaGN(feats_in, c_in, max(1, c_in // group_size)), nn.GELU(),
            nn.Conv2d(c_in, c_mid, 3, padding=1), Dropout(dropout_rate),
            AdaGN(feats_in, c_mid, max(1, c_mid // group_size)), nn.GELU(),
            nn.Conv2d(c_mid, c_out, 3, padding=1), Dropout(dropout_rate))
        self.skip = (nn.Identity() if c_in == c_out
                     else nn.Conv2d(c_in, c_out, 1, bias=False))

    def forward(self, x, cond):
        h = x
        for m in self.main:
            h = m(h, cond) if isinstance(m, AdaGN) else m(h)
        return h + self.skip(x)


class _Block(nn.ModuleList):
    """A D block (the downsample first) or a U block (the upsample last):
    n_layers ResConvBlocks, each followed by a SelfAttention2d where
    `self_attn` (ref: image_v2.py:31-76 DBlock/UBlock)."""

    def __init__(self, n_layers: int, feats_in: int, c_in: int, c_mid: int,
                 c_out: int, group_size: int = 32, head_size: int = 64,
                 self_attn: bool = False, downsample: bool = False,
                 upsample: bool = False, dropout_rate: float = 0.0):
        modules = [Downsample2d()] if downsample else []
        for i in range(n_layers):
            my_c_in = c_in if i == 0 else c_mid
            my_c_out = c_mid if i < n_layers - 1 else c_out
            modules.append(ResConvBlock(feats_in, my_c_in, c_mid, my_c_out,
                                        group_size, dropout_rate))
            if self_attn:
                modules.append(SelfAttention2d(
                    my_c_out, max(1, my_c_out // head_size),
                    max(1, my_c_out // group_size), feats_in,
                    dropout_rate))
        if upsample:
            modules.append(Upsample2d())
        super().__init__(modules)

    def forward(self, x, cond):
        for m in self:
            x = m(x, cond) if isinstance(
                m, (ResConvBlock, SelfAttention2d)) else m(x)
        return x


class UNet(nn.Module):
    """(ref: k_diffusion/layers.py UNet): the down blocks from
    `skip_stages` on, each output kept, then the up blocks, each after
    the first on its input concatenated with the matching skip."""

    def __init__(self, d_blocks, u_blocks, skip_stages: int = 0):
        super().__init__()
        self.d_blocks = nn.ModuleList(d_blocks)
        self.u_blocks = nn.ModuleList(u_blocks)
        self.skip_stages = skip_stages

    def forward(self, x, cond):
        skips = []
        for block in self.d_blocks[self.skip_stages:]:
            x = block(x, cond)
            skips.append(x)
        for i, (block, skip) in enumerate(zip(self.u_blocks,
                                              reversed(skips))):
            if i > 0:
                x = torch.cat([x, skip], dim=1)
            x = block(x, cond)
        return x


class _ImageDenoiser(nn.Module):
    """What V1 and V2 share (ref: image_v1.py / image_v2.py __init__ and
    the forward up to proj_out): sigma's Fourier features plus the mapping
    conditioning, the 2-layer GELU MappingNet (`mapping.{0,2}`),
    `unet_cond` concatenated on the channels, pixel unshuffle by
    patch_size, proj_in, the UNet, proj_out. `dropout_rate` is every
    block's dropout (after each conv of a ResConvBlock, on the attention
    weights), live under train()."""

    def __init__(self, c_in: int, feats_in: int, depths: Sequence[int],
                 channels: Sequence[int], self_attn_depths: Sequence[bool],
                 mapping_cond_dim: int = 0, unet_cond_dim: int = 0,
                 dropout_rate: float = 0.0, patch_size: int = 1,
                 skip_stages: int = 0, has_variance: bool = False,
                 device="cuda"):
        super().__init__()
        self.c_in, self.patch_size = c_in, patch_size
        self.has_variance = has_variance
        self.timestep_embed = FourierFeatures(1, feats_in)
        if mapping_cond_dim > 0:
            self.mapping_cond = nn.Linear(mapping_cond_dim, feats_in,
                                          bias=False)
        self.mapping = nn.Sequential(
            nn.Linear(feats_in, feats_in), nn.GELU(),
            nn.Linear(feats_in, feats_in), nn.GELU())
        c0 = channels[max(0, skip_stages - 1)]
        self.proj_in = nn.Conv2d((c_in + unet_cond_dim) * patch_size ** 2,
                                 c0, 1)
        self.proj_out = nn.Conv2d(c0, self.out_channels(c_in, patch_size,
                                                        has_variance), 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)
        n = len(depths)
        d_blocks = [_Block(depths[i], feats_in, channels[max(0, i - 1)],
                           channels[i], channels[i],
                           self_attn=self_attn_depths[i],
                           downsample=i > skip_stages,
                           dropout_rate=dropout_rate) for i in range(n)]
        u_blocks = [_Block(depths[i], feats_in,
                           channels[i] * 2 if i < n - 1 else channels[i],
                           channels[i], channels[max(0, i - 1)],
                           self_attn=self_attn_depths[i],
                           upsample=i > skip_stages,
                           dropout_rate=dropout_rate) for i in range(n)]
        self.u_net = UNet(d_blocks, reversed(u_blocks), skip_stages)
        self.to(device)

    @staticmethod
    def out_channels(c_in, patch_size, has_variance) -> int:
        raise NotImplementedError

    def _trunk(self, x, sigma, mapping_cond, unet_cond):
        sigma = torch.as_tensor(sigma, dtype=x.dtype,
                                device=x.device).expand(x.shape[0])
        te = self.timestep_embed((sigma.log() / 4)[:, None])
        if mapping_cond is not None:
            te = te + self.mapping_cond(mapping_cond)
        cond = self.mapping(te)
        if unet_cond is not None:
            x = torch.cat([x, unet_cond], dim=1)
        if self.patch_size > 1:
            x = F.pixel_unshuffle(x, self.patch_size)
        return self.proj_out(self.u_net(self.proj_in(x), cond))

    def _shuffle(self, h):
        return F.pixel_shuffle(h, self.patch_size) if self.patch_size > 1 \
            else h


class ImageDenoiserModelV2(_ImageDenoiser):
    """(ref: k_diffusion/models/image_v2.py:88-158; `kdip_tpu` kdiff.py:
    223-305). forward(x, sigma, mapping_cond=None, unet_cond=None,
    return_variance=False) -> the model output, or with has_variance and
    return_variance (out, logvar, logvar_ot), each [B, c_in, H, W]."""

    @staticmethod
    def out_channels(c_in, patch_size, has_variance) -> int:
        return c_in * patch_size ** 2 * (3 if has_variance else 1)

    def forward(self, x, sigma, mapping_cond: Optional[torch.Tensor] = None,
                unet_cond: Optional[torch.Tensor] = None,
                return_variance: bool = False):
        h = self._trunk(x, sigma, mapping_cond, unet_cond)
        if not self.has_variance:
            return self._shuffle(h)
        h, logvar, logvar_ot = h.chunk(3, dim=1)
        if return_variance:
            return (self._shuffle(h), self._shuffle(logvar),
                    self._shuffle(logvar_ot))
        return self._shuffle(h)


class ImageDenoiserModelV1(_ImageDenoiser):
    """(ref: k_diffusion/models/image_v1.py:87-156; `kdip_tpu` kdiff.py:
    326-404). With has_variance proj_out has one channel more, whose
    mean over the (patched) image is a scalar logvar per image;
    return_variance then returns (out, logvar [B])."""

    @staticmethod
    def out_channels(c_in, patch_size, has_variance) -> int:
        return c_in * patch_size ** 2 + (1 if has_variance else 0)

    def forward(self, x, sigma, mapping_cond: Optional[torch.Tensor] = None,
                unet_cond: Optional[torch.Tensor] = None,
                return_variance: bool = False):
        h = self._trunk(x, sigma, mapping_cond, unet_cond)
        if not self.has_variance:
            return self._shuffle(h)
        h, logvar = h[:, :-1], h[:, -1].flatten(1).mean(1)
        if return_variance:
            return self._shuffle(h), logvar
        return self._shuffle(h)


def karras_augment_wrapper(model):
    """Feeds the 9-value augmentation conditioning into the mapping net
    (ref: k_diffusion/augmentation.py:89-101 KarrasAugmentWrapper;
    `kdip_tpu` kdiff.py:308-323): aug_cond defaults to zeros, and a given
    mapping_cond is concatenated after it. Returns
    apply(x, sigma, aug_cond=None, mapping_cond=None, **kw)."""
    def apply(x, sigma, aug_cond=None, mapping_cond=None, **kwargs):
        if aug_cond is None:
            aug_cond = x.new_zeros(x.shape[0], 9)
        if mapping_cond is None:
            mapping_cond = aug_cond
        else:
            mapping_cond = torch.cat([aug_cond, mapping_cond], dim=1)
        return model(x, sigma, mapping_cond=mapping_cond, **kwargs)
    return apply
