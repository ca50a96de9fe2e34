"""The work of a guided NFE and of each kernel, counted from the
architecture's shapes (the reference model on the meta device), never from
the program: the same count whatever implements a conv. With the chip's
peaks (`peaks.json`) these give `mfu` and the kernels' rooflines.

- `unet_flops`: one UNet forward at batch B and its vjp with respect to x,
  as guidance takes it (the weights take no gradient): every conv, linear
  and attention product forward; backward, each conv on x's path once (dx)
  and both operands of each attention product. The time embedding and the
  variance head's 1x1 conv take no gradient.
- `winograd_launches`: the Winograd kernel's launches of one NFE: each
  ResBlock's two 3x3 convs forward (fused, but a down-block's first conv,
  which takes the pooled activation) and their dx (plain).
- `direct_conv_work`: a 3x3 launch's FLOPs (2 B C F 9 H W) and bytes (its
  input, weights and output once, in bfloat16; a fused launch also reads
  its float32 prologue).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Tuple

import torch

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def peaks(device_name: str):
    """The card's published peaks, or None for a card not in the table."""
    with open(PEAKS) as f:
        return json.load(f).get(device_name)


def _shapes(model, batch: int, image_size: int):
    """(convs, linears, attentions, resblocks) of one meta-device forward:
    convs [(module, in shape, out shape)], attentions [(B, C, T)],
    resblocks [(module, in shape)]."""
    from reference import adm
    convs, linears, attns, blocks = [], [], [], []
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, adm.Conv):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, n=name: convs.append((n, mod, i[0].shape,
                                                        o.shape))))
        elif isinstance(m, adm.Linear):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o: linears.append((mod, i[0].shape))))
        elif isinstance(m, adm.AttentionBlock):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o: attns.append((mod.heads, i[0].shape))))
        elif isinstance(m, adm.ResBlock):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o: blocks.append((mod, i[0].shape))))
    x = torch.zeros(batch, 3, image_size, image_size, device="meta")
    t = torch.zeros(batch, device="meta")
    try:
        with torch.no_grad():
            model(x, t)
    finally:
        for h in hooks:
            h.remove()
    return convs, linears, attns, blocks


def unet_flops(model, batch: int, image_size: int) -> Dict[str, int]:
    """{"forward", "vjp", "total"} FLOPs of one guided NFE's model work."""
    convs, linears, attns, _ = _shapes(model, batch, image_size)
    conv_fwd = conv_vjp = 0
    for name, m, _, out in convs:
        f = 2 * m.weight[0].numel() * out.numel()
        conv_fwd += f
        if not name.startswith("out_cov"):
            conv_vjp += f
    lin = sum(2 * m.in_features * m.out_features * shape[0]
              for m, shape in linears)
    att = 0
    for _, (B, C, H, W) in attns:
        T = H * W
        att += 2 * (2 * B * T * T * C)   # q.k and w.v over all heads
    fwd = conv_fwd + lin + att
    vjp = conv_vjp + 2 * att
    return {"forward": fwd, "vjp": vjp, "total": fwd + vjp}


def winograd_launches(model, batch: int, image_size: int
                      ) -> Dict[Tuple, int]:
    """{(entry point, B, C, F, H, W): launches} of one NFE."""
    _, _, _, blocks = _shapes(model, batch, image_size)
    out = Counter()
    for blk, (B, C, H, W) in blocks:
        if blk.up:
            H, W = 2 * H, 2 * W
        elif blk.down:
            H, W = H // 2, W // 2
        F = blk.in_layers[2].weight.shape[0]
        first = "winograd_conv3x3" if blk.down else "winograd_conv3x3_fused"
        out[(first, B, C, F, H, W)] += 1
        out[("winograd_conv3x3_fused", B, F, F, H, W)] += 1
        out[("winograd_conv3x3", B, F, C, H, W)] += 1      # dx, in_conv
        out[("winograd_conv3x3", B, F, F, H, W)] += 1      # dx, out_conv
    return dict(out)


def direct_conv_work(entry: str, B: int, C: int, F: int, H: int,
                     W: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one 3x3 launch, bfloat16 operands."""
    flops = 2 * B * C * F * 9 * H * W
    nbytes = 2 * (B * C * H * W + 9 * C * F + B * F * H * W)
    if entry.endswith("_fused"):
        nbytes += 2 * 4 * B * C          # the prologue's a and b
    return flops, nbytes

