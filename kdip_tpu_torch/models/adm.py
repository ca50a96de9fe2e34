"""ADM (guided-diffusion) UNet, PyTorch port of `kdip_tpu/models/adm.py`.

Topology and module names follow guided_diffusion/unet.py:398-668
(`input_blocks.{i}.{j}`, `middle_block.{j}`, `output_blocks.{i}.{j}`,
`time_embed.{0,2}`, `out.{0,2}`), so the published state dicts load
unchanged. NCHW layout. The torso runs in the dtype of its weights
(`weights.precast_inference` makes a bfloat16 torso); its input and output
stay in the caller's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .layers import (AttentionBlock, GroupNorm32, ResBlock,
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
                 dtype=torch.float32, device="cuda"):
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
        self.to(device)

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
    """FFHQ-256 config (ref: configs/test_ffhq.json:13-17)."""
    return ADMUNet(image_size=256, model_channels=128, num_res_blocks=1,
                   attention_resolutions=(16,), channel_mult=(1, 1, 2, 2, 4, 4),
                   num_heads=4, num_head_channels=64, out_channels=6, dtype=dtype, device=device, **kw)
