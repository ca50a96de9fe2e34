"""ADM (guided-diffusion) UNet, PyTorch port of `kdip_tpu/models/adm.py`.

Topology and module names follow guided_diffusion/unet.py:398-668
(`input_blocks.{i}.{j}`, `middle_block.{j}`, `output_blocks.{i}.{j}`,
`time_embed.{0,2}`, `out.{0,2}`), so the published state dicts load
unchanged. NCHW layout. The torso runs in the dtype of its weights
(`weights.precast_inference` makes a bfloat16 torso); its input and output
stay in the caller's dtype.

`winograd=True` (adm.py:61-91) sends the ResBlocks' 3x3 convs through the
Winograd F(2,3) kernel (`ops.winograd`) in a bfloat16 or float16 torso;
the state dict does not change. The decoder concatenates each skip onto h
(`torch.cat`) where `kdip_tpu`'s low-precision torso passes the pair
split (adm.py:156-167, 188-196): the same maths, but for one bf16 rounding
of the sum in the projecting 1x1 skip conv, which `kdip_tpu` takes per
half.

Also here: the classifier (`EncoderADMUNet`, its `AttentionPool2d` and
`create_classifier`), `SuperResADMUNet` and the ImageNet-256 config
(`imagenet_unet`), with guided-diffusion's module names.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (AttentionBlock, Conv2d, Downsample, GroupNorm32,
                     ResBlock, TimestepEmbedSequential, Upsample, conv_nd,
                     timestep_embedding)

# channel multipliers by image size (ref: guided_diffusion/script_util.py:
# 148-158)
CHANNEL_MULT = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
                128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}


class ADMUNet(nn.Module):
    """The UNet with attention and timestep embedding
    (ref: guided_diffusion/unet.py:398-668; `kdip_tpu` adm.py:28-202).
    `attention_resolutions` holds downsample rates. `num_classes` adds
    `label_emb` and a class label `y` to forward; `resblock_updown=False`
    resamples with `Upsample`/`Downsample` (a conv or not, by
    `conv_resample`); `num_heads_upsample` sets the decoder's heads where
    num_head_channels is -1 (-1: num_heads). `dropout` is the ResBlocks'
    rate, live under train()."""

    def __init__(self, image_size: int = 256, in_channels: int = 3,
                 model_channels: int = 128, out_channels: int = 6,
                 num_res_blocks: int = 1,
                 attention_resolutions: Tuple[int, ...] = (16,),
                 channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4),
                 num_heads: int = 4, num_head_channels: int = 64,
                 use_new_attention_order: bool = False,
                 dtype=torch.float32, device="cuda", winograd: bool = False,
                 num_classes: Optional[int] = None,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, conv_resample: bool = True,
                 num_heads_upsample: int = -1, dropout: float = 0.0):
        super().__init__()
        self.image_size = image_size
        self.model_channels = mc = model_channels
        self.num_classes = num_classes
        emb_dim = mc * 4
        heads_up = num_heads if num_heads_upsample == -1 \
            else num_heads_upsample

        def res(ch, out_ch=None, up=False, down=False):
            return ResBlock(ch, emb_dim, dtype, out_channels=out_ch,
                            up=up, down=down,
                            use_scale_shift_norm=use_scale_shift_norm,
                            dropout=dropout)

        def attn(ch, heads):
            return AttentionBlock(ch, dtype, num_heads=heads,
                                  num_head_channels=num_head_channels,
                                  use_new_attention_order=use_new_attention_order)

        self.time_embed = nn.Sequential(nn.Linear(mc, emb_dim, dtype=dtype),
                                        nn.SiLU(),
                                        nn.Linear(emb_dim, emb_dim, dtype=dtype))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, emb_dim, dtype=dtype)

        # encoder (ref: unet.py:482-539)
        ch = int(channel_mult[0] * mc)
        blocks = [TimestepEmbedSequential(conv_nd(2, in_channels, ch, 3, dtype))]
        chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, int(mult * mc))]
                ch = int(mult * mc)
                if ds in attention_resolutions:
                    layers.append(attn(ch, num_heads))
                blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                blocks.append(TimestepEmbedSequential(
                    res(ch, ch, down=True) if resblock_updown
                    else Downsample(ch, conv_resample, dtype)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)

        # middle (ref: unet.py:541-565)
        self.middle_block = TimestepEmbedSequential(res(ch), attn(ch, num_heads),
                                                    res(ch))

        # decoder (ref: unet.py:568-612)
        blocks = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), int(mc * mult))]
                ch = int(mc * mult)
                if ds in attention_resolutions:
                    layers.append(attn(ch, heads_up))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True) if resblock_updown
                                  else Upsample(ch, conv_resample, dtype))
                    ds //= 2
                blocks.append(TimestepEmbedSequential(*layers))
        self.output_blocks = nn.ModuleList(blocks)

        # head (ref: unet.py:614-618)
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 conv_nd(2, ch, out_channels, 3, dtype))
        self.feature_channels = ch
        self.set_winograd(winograd)
        self.to(device)

    def set_winograd(self, on: bool) -> None:
        """Routes the ResBlocks' 3x3 convs through the Winograd kernel (or
        back to the direct conv). Takes effect only in a bfloat16 or
        float16 torso: the gate reads the torso's dtype at forward time,
        since a model is built in float32 and pre-cast afterwards."""
        self.winograd = on
        for m in self.modules():
            if isinstance(m, (ResBlock, Conv2d)):
                m.winograd = on

    @property
    def dtype(self) -> torch.dtype:
        """The torso's compute dtype: that of its weights."""
        return self.time_embed[0].weight.dtype

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                return_feature: bool = False):
        """x: [B, C, H, W] in [-1, 1]; timesteps: [B], possibly fractional;
        y: [B] class labels, given if and only if the model is
        class-conditional. Returns [B, out_channels, H, W] in x's dtype;
        with return_feature also the penultimate feature map, cast to x's
        dtype before the output norm (ref: unet.py:636-668, `kdip_tpu`
        adm.py:197-201)."""
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("pass a class label y if and only if the model "
                             "is class-conditional")
        dtype = self.dtype
        emb = self.time_embed(
            timestep_embedding(timesteps, self.model_channels).to(dtype))
        if y is not None:
            emb = emb + self.label_emb(y).to(dtype)
        h = x.to(dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        feature = h.to(x.dtype)
        norm, _, conv = self.out
        out = conv(norm(feature, silu=True).to(dtype)).to(x.dtype)
        if return_feature:
            return out, feature
        return out


class ADMUNetV2(nn.Module):
    """ADM UNet + the learned-covariance head of the DWT/DCT-Var models
    (ref: k_diffusion/external.py:135-169 OpenAIDenoiserV2): a 1x1 conv
    `out_cov` on the penultimate feature map, run in the torso dtype, that
    emits (logvar, logvar_ot). Module names match the reference's
    (`inner_model.*`, `out_cov.*`). forward returns (eps, logvar, logvar_ot);
    eps is in x's dtype, the two log-variances in the torso dtype."""

    def __init__(self, unet: ADMUNet, in_channels: int = 3):
        super().__init__()
        self.inner_model = unet
        w = unet.time_embed[0].weight
        self.out_cov = nn.Conv2d(unet.feature_channels, 2 * in_channels, 1,
                                 dtype=w.dtype, device=w.device)

    def forward(self, x_scaled: torch.Tensor, t: torch.Tensor):
        out, feature = self.inner_model(x_scaled, t, return_feature=True)
        C = x_scaled.shape[1]
        cov = self.out_cov(feature.to(self.out_cov.weight.dtype))
        logvar, logvar_ot = cov.chunk(2, dim=1)
        return out[:, :C], logvar, logvar_ot


def ffhq_unet(dtype=torch.float32, device="cuda", **kw) -> ADMUNet:
    """FFHQ-256 config (ref: configs/test_ffhq.json:13-17); `winograd=`
    passes through."""
    return ADMUNet(image_size=256, model_channels=128, num_res_blocks=1,
                   attention_resolutions=(16,), channel_mult=(1, 1, 2, 2, 4, 4),
                   num_heads=4, num_head_channels=64, out_channels=6, dtype=dtype, device=device, **kw)


def imagenet_unet(dtype=torch.float32, class_cond: bool = False,
                  device="cuda", **kw) -> ADMUNet:
    """ImageNet-256 config (ref: configs/test_imagenet.json:13-17; `kdip_tpu`
    adm.py:457-465): 256 channels, 2 res blocks, attention at 8, 16 and
    32 px; `winograd=` passes through."""
    return ADMUNet(image_size=256, model_channels=256, num_res_blocks=2,
                   attention_resolutions=(8, 16, 32),
                   channel_mult=(1, 1, 2, 2, 4, 4), num_heads=4,
                   num_head_channels=64, out_channels=6,
                   num_classes=1000 if class_cond else None, dtype=dtype,
                   device=device, **kw)


def create_unet(image_size: int = 256, num_channels: int = 128,
                num_res_blocks: int = 1, channel_mult: str = "",
                learn_sigma: bool = True, class_cond: bool = False,
                attention_resolutions: str = "16", num_heads: int = 4,
                num_head_channels: int = 64, num_heads_upsample: int = -1,
                use_scale_shift_norm: bool = True, dropout: float = 0.0,
                resblock_updown: bool = True,
                use_new_attention_order: bool = False, dtype=torch.float32,
                device="cuda", winograd: bool = False) -> ADMUNet:
    """Flag-compatible factory (ref: guided_diffusion/script_util.py:130-184;
    `kdip_tpu` adm.py:468-500). `channel_mult` is "" (the image size's
    preset), a comma-separated string or a tuple. `dropout` is the
    ResBlocks' rate, live under train()."""
    if channel_mult == "":
        if image_size not in CHANNEL_MULT:
            raise ValueError(f"no channel multiplier preset for image size "
                             f"{image_size}")
        mult: Tuple[float, ...] = CHANNEL_MULT[image_size]
    elif isinstance(channel_mult, str):
        mult = tuple(int(m) for m in channel_mult.split(","))
    else:
        mult = tuple(channel_mult)
    attention_ds = tuple(image_size // int(r)
                         for r in attention_resolutions.split(","))
    return ADMUNet(image_size=image_size, in_channels=3,
                   model_channels=num_channels,
                   out_channels=6 if learn_sigma else 3,
                   num_res_blocks=num_res_blocks,
                   attention_resolutions=attention_ds, channel_mult=mult,
                   num_classes=1000 if class_cond else None,
                   num_heads=num_heads, num_head_channels=num_head_channels,
                   num_heads_upsample=num_heads_upsample,
                   use_scale_shift_norm=use_scale_shift_norm,
                   resblock_updown=resblock_updown,
                   use_new_attention_order=use_new_attention_order,
                   dropout=dropout, dtype=dtype, device=device,
                   winograd=winograd)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (ref: guided_diffusion/unet.py:22-63;
    `kdip_tpu` adm.py:205-249): the mean token prepended, a learned
    positional embedding added, one multi-head attention pass (the new
    head order) and the mean token's output projected. The positional
    embedding is stored [C, T+1], as guided-diffusion stores it (`kdip_tpu`
    transposes it to [T+1, C]); the logits and softmax run in float32."""

    def __init__(self, spacial_dim: int, embed_dim: int,
                 num_head_channels: int, output_dim: Optional[int],
                 dtype):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1, dtype=dtype)
            / embed_dim ** 0.5)
        self.qkv_proj = conv_nd(1, embed_dim, 3 * embed_dim, 1, dtype)
        self.c_proj = conv_nd(1, embed_dim, output_dim or embed_dim, 1,
                              dtype)
        self.num_heads = embed_dim // num_head_channels

    def forward(self, x):
        B, C = x.shape[:2]
        x = x.reshape(B, C, -1)
        x = torch.cat([x.mean(dim=-1, keepdim=True), x], dim=-1)
        x = x + self.positional_embedding[None].to(x.dtype)
        q, k, v = self.qkv_proj(
            x.to(self.qkv_proj.weight.dtype)).chunk(3, dim=1)
        heads, T = self.num_heads, x.shape[-1]
        ch = C // heads
        q, k, v = (t.reshape(B * heads, ch, T) for t in (q, k, v))
        scale = 1 / math.sqrt(math.sqrt(ch))
        logits = torch.einsum("bct,bcs->bts", (q * scale).to(torch.float32),
                              (k * scale).to(torch.float32))
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        a = torch.einsum("bts,bcs->bct", weights, v).reshape(B, C, T)
        return self.c_proj(a)[:, :, 0]


class EncoderADMUNet(nn.Module):
    """The half-UNet classifier (ref: guided_diffusion/unet.py:688-899
    EncoderUNetModel; `kdip_tpu` adm.py:252-383): the ADM encoder and
    middle block with a pooling head, `pool` one of "adaptive",
    "attention", "spatial" and "spatial_v2". Module names are
    guided-diffusion's (`out.{0,2}` etc.), so its state dicts load
    unchanged (`ckpt.load_strict`). forward(x, t) -> [B, out_channels]
    logits in x's dtype."""

    def __init__(self, image_size: int = 64, in_channels: int = 3,
                 model_channels: int = 128, out_channels: int = 1000,
                 num_res_blocks: int = 2,
                 attention_resolutions: Tuple[int, ...] = (2, 4, 8),
                 channel_mult: Tuple[float, ...] = (1, 2, 3, 4),
                 conv_resample: bool = True, num_heads: int = 1,
                 num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True,
                 use_new_attention_order: bool = False,
                 pool: str = "attention", dtype=torch.float32,
                 device="cuda", dropout: float = 0.0):
        super().__init__()
        if pool not in ("adaptive", "attention", "spatial", "spatial_v2"):
            raise NotImplementedError(f"Unexpected {pool} pooling")
        self.model_channels = mc = model_channels
        self.pool = pool
        emb_dim = mc * 4

        def res(ch, out_ch=None, down=False):
            return ResBlock(ch, emb_dim, dtype, out_channels=out_ch,
                            down=down,
                            use_scale_shift_norm=use_scale_shift_norm,
                            dropout=dropout)

        def attn(ch):
            return AttentionBlock(ch, dtype, num_heads=num_heads,
                                  num_head_channels=num_head_channels,
                                  use_new_attention_order=use_new_attention_order)

        self.time_embed = nn.Sequential(nn.Linear(mc, emb_dim, dtype=dtype),
                                        nn.SiLU(),
                                        nn.Linear(emb_dim, emb_dim, dtype=dtype))
        ch = int(channel_mult[0] * mc)
        blocks = [TimestepEmbedSequential(conv_nd(2, in_channels, ch, 3, dtype))]
        feature_size = ch
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, int(mult * mc))]
                ch = int(mult * mc)
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                blocks.append(TimestepEmbedSequential(*layers))
                feature_size += ch
            if level != len(channel_mult) - 1:
                blocks.append(TimestepEmbedSequential(
                    res(ch, ch, down=True) if resblock_updown
                    else Downsample(ch, conv_resample, dtype)))
                ds *= 2
                feature_size += ch
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = TimestepEmbedSequential(res(ch), attn(ch), res(ch))
        feature_size += ch

        # the head (ref: unet.py:828-860)
        if pool == "adaptive":
            self.out = nn.Sequential(
                GroupNorm32(ch), nn.SiLU(), nn.AdaptiveAvgPool2d((1, 1)),
                conv_nd(2, ch, out_channels, 1, dtype), nn.Flatten())
        elif pool == "attention":
            self.out = nn.Sequential(
                GroupNorm32(ch), nn.SiLU(),
                AttentionPool2d(image_size // ds, ch, num_head_channels,
                                out_channels, dtype))
        elif pool == "spatial":
            self.out = nn.Sequential(
                nn.Linear(feature_size, 2048, dtype=dtype), nn.ReLU(),
                nn.Linear(2048, out_channels, dtype=dtype))
        else:
            self.out = nn.Sequential(
                nn.Linear(feature_size, 2048, dtype=dtype),
                GroupNorm32(2048), nn.SiLU(),
                nn.Linear(2048, out_channels, dtype=dtype))
        self.to(device)

    @property
    def dtype(self) -> torch.dtype:
        return self.time_embed[0].weight.dtype

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor):
        """x: [B, C, H, W]; timesteps: [B]. Returns [B, out_channels]
        logits (ref: unet.py:880-899)."""
        dtype = self.dtype
        emb = self.time_embed(
            timestep_embedding(timesteps, self.model_channels).to(dtype))
        spatial = self.pool.startswith("spatial")
        h = x.to(dtype)
        results = []
        for block in self.input_blocks:
            h = block(h, emb)
            if spatial:
                results.append(h.to(x.dtype).mean(dim=(2, 3)))
        h = self.middle_block(h, emb)
        if spatial:
            results.append(h.to(x.dtype).mean(dim=(2, 3)))
            h = torch.cat(results, dim=-1)
        else:
            h = h.to(x.dtype)  # the norm and pooling in x's dtype
        for m in self.out:
            h = m(h.to(m.weight.dtype) if isinstance(
                m, (nn.Linear, nn.Conv2d)) else h)
        return h.to(x.dtype)


def create_classifier(image_size: int = 64,
                      classifier_use_fp16: bool = False,
                      classifier_width: int = 128, classifier_depth: int = 2,
                      classifier_attention_resolutions: str = "32,16,8",
                      classifier_use_scale_shift_norm: bool = True,
                      classifier_resblock_updown: bool = True,
                      classifier_pool: str = "attention",
                      out_channels: int = 1000,
                      device="cuda") -> EncoderADMUNet:
    """Flag-compatible classifier factory
    (ref: guided_diffusion/script_util.py:27-41, 228-267; `kdip_tpu`
    adm.py:386-406). `classifier_use_fp16` builds a bfloat16 torso."""
    attention_ds = tuple(image_size // int(r)
                         for r in classifier_attention_resolutions.split(","))
    return EncoderADMUNet(
        image_size=image_size, in_channels=3, model_channels=classifier_width,
        out_channels=out_channels, num_res_blocks=classifier_depth,
        attention_resolutions=attention_ds,
        channel_mult=CHANNEL_MULT[image_size], num_head_channels=64,
        use_scale_shift_norm=classifier_use_scale_shift_norm,
        resblock_updown=classifier_resblock_updown, pool=classifier_pool,
        dtype=torch.bfloat16 if classifier_use_fp16 else torch.float32,
        device=device)


class SuperResADMUNet(ADMUNet):
    """A UNet conditioned on a bilinear upsample of a low-resolution image,
    concatenated onto its input channels (ref: guided_diffusion/unet.py:
    671-685 SuperResModel, a subclass, so its state dict is the UNet's;
    `kdip_tpu` adm.py:409-421). Build it with in_channels = 2 x the
    image's. The upsample is `F.interpolate(mode="bilinear",
    align_corners=False)`, the half-pixel sampling of `kdip_tpu`'s
    `jax.image.resize(..., "bilinear")` when it enlarges."""

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: Optional[torch.Tensor] = None, **kwargs):
        up = F.interpolate(low_res, size=x.shape[2:], mode="bilinear",
                           align_corners=False)
        return super().forward(torch.cat([x, up], dim=1), timesteps,
                               **kwargs)
