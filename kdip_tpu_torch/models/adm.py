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
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .layers import (AttentionBlock, Conv2d, GroupNorm32, ResBlock,
                     TimestepEmbedSequential, conv_nd, timestep_embedding)


class ADMUNet(nn.Module):
    """The UNet with attention and timestep embedding
    (ref: guided_diffusion/unet.py:398-668), with resblock up/down sampling
    and scale-shift norm, which every ADM config of this repo uses. `attention_resolutions` holds
    downsample rates."""

    def __init__(self, image_size: int = 256, in_channels: int = 3,
                 model_channels: int = 128, out_channels: int = 6,
                 num_res_blocks: int = 1,
                 attention_resolutions: Tuple[int, ...] = (16,),
                 channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4),
                 num_heads: int = 4, num_head_channels: int = 64,
                 use_new_attention_order: bool = False,
                 dtype=torch.float32, device="cuda", winograd: bool = False):
        super().__init__()
        self.image_size = image_size
        self.model_channels = mc = model_channels
        emb_dim = mc * 4

        def res(ch, out_ch=None, up=False, down=False):
            return ResBlock(ch, emb_dim, dtype, out_channels=out_ch,
                            up=up, down=down)

        def attn(ch, heads):
            return AttentionBlock(ch, dtype, num_heads=heads,
                                  num_head_channels=num_head_channels,
                                  use_new_attention_order=use_new_attention_order)

        self.time_embed = nn.Sequential(nn.Linear(mc, emb_dim, dtype=dtype),
                                        nn.SiLU(),
                                        nn.Linear(emb_dim, emb_dim, dtype=dtype))

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
                blocks.append(TimestepEmbedSequential(res(ch, ch, down=True)))
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
                    layers.append(attn(ch, num_heads))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True))
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
                return_feature: bool = False):
        """x: [B, C, H, W] in [-1, 1]; timesteps: [B], possibly fractional.
        Returns [B, out_channels, H, W] in x's dtype; with return_feature
        also the penultimate feature map, cast to x's dtype before the
        output norm (ref: unet.py:636-668, `kdip_tpu` adm.py:197-201)."""
        dtype = self.dtype
        emb = self.time_embed(
            timestep_embedding(timesteps, self.model_channels).to(dtype))
        h = x.to(dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        feature = h.to(x.dtype)
        norm, act, conv = self.out
        out = conv(act(norm(feature)).to(dtype)).to(x.dtype)
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
    `kdip_tpu` adm.py:468-500). `dropout` is accepted and unused: the port
    runs inference only. Flags whose modules are not ported raise."""
    unported = {"class_cond": class_cond, "use_scale_shift_norm=False":
                not use_scale_shift_norm, "resblock_updown=False":
                not resblock_updown, "num_heads_upsample": num_heads_upsample
                not in (-1, num_heads)}
    for flag, on in unported.items():
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet: a later slice of the PyTorch "
                f"port (ROADMAP queue 1, item 12)")
    if channel_mult == "":
        mult: Tuple[float, ...] = {
            512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
            128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}[image_size]
    else:
        mult = tuple(int(m) for m in channel_mult.split(","))
    attention_ds = tuple(image_size // int(r)
                         for r in attention_resolutions.split(","))
    return ADMUNet(image_size=image_size, in_channels=3,
                   model_channels=num_channels,
                   out_channels=6 if learn_sigma else 3,
                   num_res_blocks=num_res_blocks,
                   attention_resolutions=attention_ds, channel_mult=mult,
                   num_heads=num_heads, num_head_channels=num_head_channels,
                   use_new_attention_order=use_new_attention_order,
                   dtype=dtype, device=device, winograd=winograd)
