"""InceptionV3 feature extractor for FID (PyTorch port of
`kdip_tpu/models/inception.py`; ref: k_diffusion/evaluation.py:17-33, via
the clean-fid wheel).

The torchvision InceptionV3 trunk up to the 2048-dim average pool, NCHW,
with the FID-specific changes: the 3x3 average pools exclude the padding
(count_include_pad=False) and Mixed_7c's pool branch is a stride-1 max
pool. Parameter names are torchvision's / pt_inception's, so
`pt_inception-2015-12-05-*.pth` loads strictly once its `fc.*` (and any
`AuxLogits.*`) entries are dropped.

Inputs: [B, 3, H, W] in [-1, 1], resized to 299 x 299 with
`jax.image.resize`'s bilinear (`ops.resize.jax_resize`), as `kdip_tpu`
resizes them. Output: [B, 2048] pooled features.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import jax_resize

INPUT_SIZE = 299


class BasicConv2d(nn.Module):
    """A conv without bias, BatchNorm from its running statistics (eps
    1e-3) and ReLU (`kdip_tpu` inception.py:25-43)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nocount(x):
    """3x3 average pool, stride 1, pad 1, count_include_pad=False (the FID
    fix; `kdip_tpu` inception.py:46)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """Mixed_7b pools by average, Mixed_7c by a stride-1, pad-1 max pool
    (`kdip_tpu` inception.py:145)."""

    def __init__(self, in_ch: int, pool_type: str = "avg"):
        super().__init__()
        self.pool_type = pool_type
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.pool_type == "avg":
            bp = _avg_pool_nocount(x)
        else:
            bp = F.max_pool2d(x, 3, 1, 1)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3Features(nn.Module):
    """The trunk to the 2048-dim pooled features (the FID backbone):
    [B, 3, H, W] in [-1, 1] -> [B, 2048]."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        # pt_inception takes the [-1, 1] scaling as it is
        x = jax_resize(x, (INPUT_SIZE, INPUT_SIZE), "bilinear")
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                  self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                  self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = m(x)
        return x.mean(dim=(2, 3))


def make_inception_extractor(weights: Mapping[str, torch.Tensor],
                             device="cuda") -> Callable:
    """The FID feature extractor: `weights`, a pt_inception state dict,
    loaded strictly (less `fc.*` / `AuxLogits.*`) into the trunk on
    `device`, in eval() under no_grad. Returns fn(batch) -> [B, 2048] for
    an NCHW batch in [-1, 1] (a tensor on any device, or an array)."""
    model = InceptionV3Features()
    # the classifier and the auxiliary head are not the FID trunk's
    # (`kdip_tpu`'s converter skips them too)
    model.load_state_dict({k: v for k, v in weights.items()
                           if not k.startswith(("fc.", "AuxLogits."))},
                          strict=True)
    model = model.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def extract(batch):
        return model(torch.as_tensor(batch).to(device, torch.float32))

    extract.model = model
    return extract
