"""Per-image quality metrics: PSNR, SSIM, LPIPS (PyTorch port of
`kdip_tpu/metrics.py:26-204`; ref: sample_condition_openai.py:41-68).

NCHW tensors. `psnr`, `ssim` and `lpips_vgg` run on the tensor's device in
float32; `ssim_f64` is the float64 host SSIM that per-image reporting
uses (skimage's defaults: 7x7 uniform window, K1=0.01, K2=0.03, sample
covariance, channel-averaged). `lpips_vgg` takes the tensors of
`weights.lpips_from_jax_params`: `conv{i}.weight` (OIHW), `conv{i}.bias`
and `lin{i}.weight` ([C], the learned non-negative channel weights).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F


def to_eval(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1] clipped (ref: sample_condition_openai.py:42-43)."""
    return torch.clamp(x / 2 + 0.5, 0, 1)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0
         ) -> torch.Tensor:
    """PSNR over all dims but the batch's: [B]."""
    mse = torch.mean((a - b) ** 2, dim=tuple(range(1, a.ndim)))
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _uniform_filter(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Valid-mode uniform filter over H, W of [B, C, H, W], per channel."""
    C = x.shape[1]
    kernel = torch.full((C, 1, size, size), 1.0 / (size * size),
                        dtype=x.dtype, device=x.device)
    return F.conv2d(x, kernel, groups=C)


def ssim_f64(a, b, data_range: float = 1.0, win_size: int = 7,
             k1: float = 0.01, k2: float = 0.03) -> np.ndarray:
    """Float64 host SSIM (skimage's), [B, C, H, W] tensors or arrays in,
    [B] out: `kdip_tpu`'s code, run on its NHWC layout. The float32 `ssim`
    can drift ~1e-2 above 1.0 on locally flat windows (uxx - ux^2
    cancels)."""
    from numpy.lib.stride_tricks import sliding_window_view

    def host(t):
        if torch.is_tensor(t):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float64).transpose(0, 2, 3, 1)
    a, b = host(a), host(b)

    def filt(x):  # x: [B, H, W, C]
        v = sliding_window_view(x, (win_size, win_size), axis=(1, 2))
        return v.mean(axis=(-2, -1))

    NP = win_size ** 2
    cov_norm = NP / (NP - 1)
    ux, uy = filt(a), filt(b)
    vx = cov_norm * (filt(a * a) - ux * ux)
    vy = cov_norm * (filt(b * b) - uy * uy)
    vxy = cov_norm * (filt(a * b) - ux * uy)
    C1, C2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    return S.mean(axis=tuple(range(1, S.ndim)))


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03
         ) -> torch.Tensor:
    """SSIM in float32 on the tensors' device, [B]; skimage crops the
    filtered maps by (win_size-1)//2 a side, which the valid filter does."""
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)
    ux = _uniform_filter(a, win_size)
    uy = _uniform_filter(b, win_size)
    uxx = _uniform_filter(a * a, win_size)
    uyy = _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (k1 * data_range) ** 2
    C2 = (k2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    return torch.mean(S, dim=tuple(range(1, S.ndim)))


# ---------------------------------------------------------------------------
# LPIPS (VGG16 backbone)
# ---------------------------------------------------------------------------

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# taps after the ReLU of these convs (relu1_2, relu2_2, relu3_3, relu4_3,
# relu5_3): the standard LPIPS slices
LPIPS_TAPS = [1, 3, 6, 9, 12]

_IMAGENET_SHIFT = (-0.030, -0.088, -0.188)
_IMAGENET_SCALE = (0.458, 0.448, 0.450)


def _vgg16_features(params: Mapping[str, torch.Tensor], x: torch.Tensor
                    ) -> List[torch.Tensor]:
    """The VGG16 conv torso; returns the 5 LPIPS tap activations."""
    feats = []
    conv_idx = 0
    h = x
    for c in VGG16_CFG:
        if c == "M":
            h = F.max_pool2d(h, 2)
            continue
        h = F.relu(F.conv2d(h, params[f"conv{conv_idx}.weight"],
                            params[f"conv{conv_idx}.bias"], padding=1))
        if conv_idx in LPIPS_TAPS:
            feats.append(h)
        conv_idx += 1
    return feats


def lpips_vgg(params: Mapping[str, torch.Tensor], a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance with the VGG backbone, [B]. a, b: [B, 3, H, W] in
    [0, 1] (the reference applies it to to_eval outputs,
    sample_condition_openai.py:46), float32."""
    shift = torch.tensor(_IMAGENET_SHIFT, dtype=torch.float32,
                         device=a.device)[:, None, None]
    scale = torch.tensor(_IMAGENET_SCALE, dtype=torch.float32,
                         device=a.device)[:, None, None]

    def norm_input(x):
        # lpips maps [0,1] to [-1,1], then shifts and scales per channel
        return (2 * x - 1 - shift) / scale

    fa = _vgg16_features(params, norm_input(a))
    fb = _vgg16_features(params, norm_input(b))
    total = 0.0
    for i, (xa, xb) in enumerate(zip(fa, fb)):
        na = xa / torch.sqrt(torch.sum(xa ** 2, dim=1, keepdim=True) + 1e-10)
        nb = xb / torch.sqrt(torch.sum(xb ** 2, dim=1, keepdim=True) + 1e-10)
        lin = params[f"lin{i}.weight"][None, :, None, None]
        total = total + torch.mean(torch.sum((na - nb) ** 2 * lin, dim=1),
                                   dim=(1, 2))
    return total


# ---------------------------------------------------------------------------
# Aggregation (ref: sample_condition_openai.py:41-68)
# ---------------------------------------------------------------------------

def compute_metrics(hat_x0: torch.Tensor, x0: torch.Tensor,
                    lpips_params: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Dict[str, float]:
    """Per-image metrics of batch element 0 of [-1,1] NCHW tensors
    (ref: sample_condition_openai.py:41-49)."""
    a = to_eval(x0.to(torch.float32))
    b = to_eval(hat_x0.to(torch.float32))
    out = {"psnr": float(psnr(a, b)[0]), "ssim": float(ssim_f64(a, b)[0])}
    if lpips_params is not None:
        out["lpips"] = float(lpips_vgg(lpips_params, a, b)[0])
    return out


def calculate_average_metric(metrics_list: List[Dict[str, float]]
                             ) -> Dict[str, float]:
    """ref: sample_condition_openai.py:52-68"""
    avg, count = {}, {}
    for metrics in metrics_list:
        for k, v in metrics.items():
            avg[k] = avg.get(k, 0.0) + v
            count[k] = count.get(k, 0) + 1
    return {k: avg[k] / count[k] for k in avg if count[k] > 0}
