"""Distribution metrics: FID and KID over feature sets (PyTorch port of
`kdip_tpu/evaluation.py`; ref: k_diffusion/evaluation.py:36-134).

Every metric runs in float32 on the features' device, as `kdip_tpu` runs
it with x64 off. `compute_features` streams batches through a feature
extractor; batch i is drawn with a torch.Generator seeded from
SeedSequence([seed, i]) (`utils.seeded_generator`) where `kdip_tpu` folds
i into a jax key. `make_clip_extractor` runs transformers' torch
`CLIPVisionModel` from a local checkpoint directory; the Inception
backbone is `models.inception`.
"""

from __future__ import annotations

from typing import Callable

import torch

from .ops.resize import jax_resize
from .utils import seeded_generator

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def compute_features(sample_fn: Callable, extractor_fn: Callable, n: int,
                     batch_size: int, seed: int, device="cuda"
                     ) -> torch.Tensor:
    """The first n features of the batches sample_fn(generator, batch_size)
    through extractor_fn (ref: k_diffusion/evaluation.py:53-63); batch i's
    generator, on `device`, is seeded from SeedSequence([seed, i])."""
    feats = []
    seen = i = 0
    while seen < n:
        cur = min(batch_size, n - seen)
        batch = sample_fn(seeded_generator(device, seed, i), batch_size)
        feats.append(extractor_fn(batch)[:cur])
        seen += cur
        i += 1
    return torch.cat(feats)[:n]


def make_clip_extractor(model_path: str, device="cuda") -> Callable:
    """CLIP image features (the reference's CLIPFeatureExtractor,
    k_diffusion/evaluation.py:36-50) from transformers' torch
    `CLIPVisionModel` in the local checkpoint directory `model_path`.
    Returns fn(batch) -> [B, D] L2-normalised pooled features for an NCHW
    batch in [-1, 1]: mapped to [0, 1], resized with jax's bicubic to the
    model's image_size, normalised by CLIP's mean and std. Raises
    ImportError, naming the package, where transformers is missing."""
    try:
        from transformers import CLIPVisionModel
    except ImportError as e:
        raise ImportError("the clip backbone needs the transformers package"
                          f", which is not installed: {e}") from None
    model = CLIPVisionModel.from_pretrained(model_path).to(device).eval()
    model.requires_grad_(False)
    size = model.config.image_size
    mean = torch.tensor(CLIP_MEAN, device=device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=device)[:, None, None]

    @torch.no_grad()
    def extract(batch):
        x = (torch.as_tensor(batch).to(device, torch.float32) + 1) / 2
        x = (jax_resize(x, (size, size), "bicubic") - mean) / std
        feats = model(pixel_values=x).pooler_output
        return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)

    return extract


def polynomial_kernel(x, y):
    """(ref: k_diffusion/evaluation.py:66-69)"""
    d = x.shape[-1]
    return (x @ y.T / d + 1) ** 3


def squared_mmd(x, y, kernel=polynomial_kernel):
    """Unbiased squared MMD (ref: k_diffusion/evaluation.py:72-84)."""
    m, n = x.shape[0], y.shape[0]
    kxx = kernel(x, x)
    kyy = kernel(y, y)
    kxy = kernel(x, y)
    kxx_sum = kxx.sum() - torch.trace(kxx)
    kyy_sum = kyy.sum() - torch.trace(kyy)
    term_1 = kxx_sum / m / (m - 1)
    term_2 = kyy_sum / n / (n - 1)
    term_3 = kxy.sum() * 2 / m / n
    return term_1 + term_2 - term_3


def kid(x, y, max_size: int = 5000):
    """Unbiased KID averaged over ceil(max(len) / max_size) partitions,
    their bounds rounded by Python's round (banker's rounding), as
    `kdip_tpu` cuts them (ref: k_diffusion/evaluation.py:87-96)."""
    x_size, y_size = x.shape[0], y.shape[0]
    n_partitions = -(-max(x_size, y_size) // max_size)
    total = 0.0
    for i in range(n_partitions):
        cur_x = x[round(i * x_size / n_partitions):
                  round((i + 1) * x_size / n_partitions)]
        cur_y = y[round(i * y_size / n_partitions):
                  round((i + 1) * y_size / n_partitions)]
        total = total + squared_mmd(cur_x, cur_y)
    return total / n_partitions


def sqrtm_eig(a):
    """Symmetric matrix square root by eigendecomposition, eigenvalues
    clipped at 0 (ref: k_diffusion/evaluation.py:99-111). The input is
    symmetrised first, as jnp.linalg.eigh does by default: a product such
    as fid's C^1/2 S C^1/2 is symmetric only to rounding."""
    vals, vecs = torch.linalg.eigh((a + a.T) / 2)
    return (vecs * torch.sqrt(torch.clamp(vals, min=0))[None]) @ vecs.T


def fid(x, y, eps: float = 1e-8):
    """Frechet distance between two feature sets, covariances normalised
    by n - 1 with eps*I added (ref: k_diffusion/evaluation.py:114-134)."""
    x_mean, y_mean = x.mean(dim=0), y.mean(dim=0)
    mean_term = torch.sum((x_mean - y_mean) ** 2)
    n, m = x.shape[0], y.shape[0]
    x_cov = (x - x_mean).T @ (x - x_mean) / (n - 1)
    y_cov = (y - y_mean).T @ (y - y_mean) / (m - 1)
    eps_eye = torch.eye(x_cov.shape[0], dtype=x.dtype, device=x.device) * eps
    x_cov = x_cov + eps_eye
    y_cov = y_cov + eps_eye
    x_cov_sqrt = sqrtm_eig(x_cov)
    cov_term = torch.trace(x_cov) + torch.trace(y_cov) - 2 * torch.trace(
        sqrtm_eig(x_cov_sqrt @ y_cov @ x_cov_sqrt))
    return mean_term + cov_term
