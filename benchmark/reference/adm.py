"""The ADM UNet of guided-diffusion (Dhariwal & Nichol 2021,
github.com/openai/guided-diffusion, unet.py) in plain float32 PyTorch: the
benchmark's reference for the model that the program serves.

No kernel, cache or precision trick: every conv, linear and attention
product is one torch call on float32 tensors, GroupNorm is
`F.group_norm`. Parameter names are guided-diffusion's
(`input_blocks.{i}.{j}`, `in_layers.0`, ...), and with the learned
covariance head of the DWT/DCT-Var models (k-diffusion-inverse-problems,
OpenAIDenoiserV2) they sit under `inner_model.` beside `out_cov.`, so one
state dict fits the program's model and this one.

`q`, where given, rounds the operands of every conv, linear and attention
product before it runs (the control's lower precision, `lowp.py`); the
reference itself passes none.

Only what the benchmark's configurations use is here: scale-shift norm,
resampling inside the ResBlocks (`resblock_updown`), the legacy or the new
attention head order, no class labels.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

CHANNEL_MULT = {256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4),
                64: (1, 2, 3, 4)}


def _q(q: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if q is None else q(t)


class Linear(nn.Linear):
    def __init__(self, cin, cout, q: Quant):
        super().__init__(cin, cout)
        self.q = q

    def forward(self, x):
        return F.linear(_q(self.q, x), _q(self.q, self.weight), self.bias)


class Conv(nn.Module):
    """A same-padded conv over 1 or 2 spatial dims, stride 1 (nn.Conv1d's
    and nn.Conv2d's parameter names and shapes)."""

    def __init__(self, dims: int, cin: int, cout: int, k: int, q: Quant):
        super().__init__()
        shape = (cout, cin) + (k,) * dims
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout))
        self.fn = F.conv1d if dims == 1 else F.conv2d
        self.pad = k // 2
        self.q = q

    def forward(self, x):
        return self.fn(_q(self.q, x), _q(self.q, self.weight), self.bias,
                       padding=self.pad)


class GroupNorm(nn.GroupNorm):
    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of float timesteps [B], cos first (nn.py)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, ch: int, emb: int, out: int, q: Quant,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(GroupNorm(ch), nn.SiLU(),
                                       Conv(2, ch, out, 3, q))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb, 2 * out, q))
        self.out_layers = nn.Sequential(GroupNorm(out), nn.SiLU(),
                                        nn.Identity(), Conv(2, out, out, 3, q))
        self.skip_connection = (nn.Identity() if out == ch
                                else Conv(2, ch, out, 1, q))

    def _resample(self, h):
        if self.up:
            return F.interpolate(h, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(h, 2)
        return h

    def forward(self, x, emb):
        norm, act, conv = self.in_layers
        h = self._resample(act(norm(x)))
        x = self._resample(x)
        h = conv(h)
        scale, shift = self.emb_layers(emb)[:, :, None, None].chunk(2, dim=1)
        out_norm, out_act, _, out_conv = self.out_layers
        h = out_conv(out_act(out_norm(h) * (1 + scale) + shift))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    def __init__(self, ch: int, head_channels: int, new_order: bool,
                 q: Quant):
        super().__init__()
        self.heads = ch // head_channels
        self.new_order = new_order
        self.norm = GroupNorm(ch)
        self.qkv = Conv(1, ch, 3 * ch, 1, q)
        self.proj_out = Conv(1, ch, ch, 1, q)
        self.q = q

    def forward(self, x):
        B, C, H, W = x.shape
        heads, ch, T = self.heads, C // self.heads, H * W
        h = x.reshape(B, C, T)
        qkv = self.qkv(self.norm(h))
        if self.new_order:
            qs, ks, vs = (t.reshape(B * heads, ch, T)
                          for t in qkv.chunk(3, dim=1))
        else:
            qs, ks, vs = qkv.reshape(B * heads, 3 * ch, T).split(ch, dim=1)
        scale = 1 / math.sqrt(math.sqrt(ch))
        logits = torch.einsum("bct,bcs->bts", _q(self.q, qs * scale),
                              _q(self.q, ks * scale))
        w = torch.softmax(logits, dim=-1)
        a = torch.einsum("bts,bcs->bct", _q(self.q, w), _q(self.q, vs))
        return (h + self.proj_out(a.reshape(B, C, T))).reshape(B, C, H, W)


class Seq(nn.ModuleList):
    """guided-diffusion's TimestepEmbedSequential."""

    def forward(self, x, emb):
        for m in self:
            x = m(x, emb) if isinstance(m, ResBlock) else m(x)
        return x


class UNet(nn.Module):
    """The ADM UNet (unet.py:398-668): returns [B, out_channels, H, W],
    and with `feature` also the map before the output norm."""

    def __init__(self, image_size: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_ds: Sequence[int], channel_mult: Tuple[int, ...],
                 num_head_channels: int, new_order: bool, q: Quant = None,
                 in_channels: int = 3):
        super().__init__()
        mc = self.model_channels = model_channels
        emb = 4 * mc
        self.time_embed = nn.Sequential(Linear(mc, emb, q), nn.SiLU(),
                                        Linear(emb, emb, q))

        def attn(c):
            return AttentionBlock(c, num_head_channels, new_order, q)

        ch = channel_mult[0] * mc
        blocks = [Seq([Conv(2, in_channels, ch, 3, q)])]
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, emb, mult * mc, q)]
                ch = mult * mc
                if ds in attention_ds:
                    layers.append(attn(ch))
                blocks.append(Seq(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                blocks.append(Seq([ResBlock(ch, emb, ch, q, down=True)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = Seq([ResBlock(ch, emb, ch, q), attn(ch),
                                 ResBlock(ch, emb, ch, q)])
        blocks = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), emb, mc * mult, q)]
                ch = mc * mult
                if ds in attention_ds:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, emb, ch, q, up=True))
                    ds //= 2
                blocks.append(Seq(layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(GroupNorm(ch), nn.SiLU(),
                                 Conv(2, ch, out_channels, 3, q))
        self.feature_channels = ch

    def forward(self, x, t, feature: bool = False):
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        h, hs = x, []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        out = self.out(h)
        return (out, h) if feature else out


class UNetV2(nn.Module):
    """The UNet with the DWT/DCT-Var head: a 1x1 conv `out_cov` on the
    feature map gives (logvar, logvar_ot). Returns (eps, logvar,
    logvar_ot)."""

    def __init__(self, unet: UNet, q: Quant = None, in_channels: int = 3):
        super().__init__()
        self.inner_model = unet
        self.out_cov = Conv(2, unet.feature_channels, 2 * in_channels, 1, q)

    def forward(self, x, t):
        out, feature = self.inner_model(x, t, feature=True)
        logvar, logvar_ot = self.out_cov(feature).chunk(2, dim=1)
        return out[:, :x.shape[1]], logvar, logvar_ot


def build(model_cfg: dict, q: Quant = None) -> nn.Module:
    """The model of a benchmark configuration's "model" block ("openai"
    flags as guided-diffusion's create_model takes them; "v2" adds the
    covariance head). Parameters are left uninitialised: the benchmark
    loads its own."""
    f = model_cfg["openai"]
    if not f["resblock_updown"] or not f["use_scale_shift_norm"] \
            or f["class_cond"] or not f["learn_sigma"]:
        raise ValueError("the reference implements resblock_updown, "
                         "scale-shift norm, learned sigma, no classes")
    size = f["image_size"]
    mult = (CHANNEL_MULT[size] if f["channel_mult"] == ""
            else tuple(int(m) for m in str(f["channel_mult"]).split(",")))
    ds = tuple(size // int(r)
               for r in str(f["attention_resolutions"]).split(","))
    if f["num_head_channels"] == -1:
        raise ValueError("the reference takes num_head_channels")
    unet = UNet(size, f["num_channels"], 6, f["num_res_blocks"], ds, mult,
                f["num_head_channels"], f["use_new_attention_order"], q)
    return UNetV2(unet, q) if model_cfg.get("v2") else unet


def norm_weight_names(model: nn.Module):
    """Names of the GroupNorm scales (drawn about 1, not about 0)."""
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, nn.GroupNorm)}


def moments(model: nn.Module, tables, v2: bool):
    """The OpenAI denoiser's moments at (x, sigma) for `guided.guided_x0`
    (k-diffusion-inverse-problems condition.py:231-300): (x0_mean on x's
    graph, theta(), raw outputs). v2 (DWT/DCT-Var): eps at the
    interpolated timestep, x0_mean = x - sigma eps, theta = exp(logvar_ot)
    sigma^2. Otherwise (Convert): the DDPM x0 prediction at the floored
    timestep, clipped to [-1, 1], and Eq. 22's covariance from the learned
    variance, (var - posterior_variance) / posterior_mean_coef1^2, at least
    1e-6."""
    from .guided import F32, c_in, f32, sigma_to_t

    def fn(x, sigma):
        B, C = x.shape[:2]
        ci = c_in(sigma)
        t_float = sigma_to_t(tables.log_sigmas, sigma)
        if v2:
            t = torch.full((B,), t_float, device=x.device)
            raw = model(x * ci, t)
            eps, _, logvar_ot = raw
            x0m = eps * f32(-F32(sigma)) + x

            def theta():
                return torch.exp(logvar_ot.detach()) * f32(F32(sigma) ** 2)
            return x0m, theta, tuple(r.detach() for r in raw)
        ti = int(t_float)
        x_in = x * ci
        raw = model(x_in, torch.full((B,), float(ti), device=x.device))
        eps, vv = raw[:, :C], raw[:, C:]
        x0m = (tables.sqrt_recip_alphas_cumprod[ti] * x_in
               - tables.sqrt_recipm1_alphas_cumprod[ti] * eps).clamp(-1, 1)

        def theta():
            frac = (vv.detach() + 1) / 2
            var = torch.exp(frac * tables.log_betas[ti] + (1 - frac)
                            * tables.posterior_log_variance_clipped[ti])
            return ((var - tables.posterior_variance[ti])
                    / tables.posterior_mean_coef1[ti] ** 2).clamp(min=1e-6)
        return x0m, theta, raw.detach()
    return fn
