"""Gradient noise scale (GNS) measurement (PyTorch port of
`kdip_tpu/gns.py:36-99`; ref: k_diffusion/gns.py, McCandlish et al.
2018).

`GradientNoiseScale` keeps its EMAs in host floats. In one process its
small-batch statistic is the microbatch gradients' mean squared norm and
its large-batch statistic the squared norm of their mean
(`train_loop.TrainLoop.run_step`). `grad_norm_stats` gives the same two
statistics across the ranks of a process group, each rank's gradient the
small batch (the reference's DDP comm hook, k_diffusion/gns.py:5-34).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .parallel import dist as pdist


def grad_norm_stats(local_grads: Sequence[torch.Tensor], group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq_norm_small, sq_norm_big), float32 0-dim tensors: the group mean
    of each rank's squared gradient norm and the squared norm of the
    group-mean gradient, what `GradientNoiseScale.update` consumes
    (`kdip_tpu` gns.py:20-35, under shard_map). `local_grads` are this
    rank's gradients, before any reduction; one all_reduce carries both.
    Without a group both are the local gradient's squared norm."""
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in local_grads])
    flat, small = pdist.mean_over_ranks(
        [flat, flat.square().sum().reshape(1)], group)
    return small[0], flat.square().sum()


class GradientNoiseScale:
    """EMA-based GNS estimator (ref: k_diffusion/gns.py:37-99).

    update(sq_norm_small_batch, sq_norm_large_batch, n_small, n_large)
    maintains EMAs of the gradient-magnitude and noise estimates;
    get_gns() = noise / scale."""

    def __init__(self, beta: float = 0.9998, eps: float = 1e-8):
        self.beta = beta
        self.eps = eps
        self.ema_sq_norm = 0.0
        self.ema_var = 0.0
        self.beta_cumprod = 1.0
        self.gradient_noise_scale = float("nan")

    def update(self, sq_norm_small_batch: float, sq_norm_large_batch: float,
               n_small_batch: int, n_large_batch: int) -> float:
        est_sq_norm = (n_large_batch * sq_norm_large_batch
                       - n_small_batch * sq_norm_small_batch) / (
            n_large_batch - n_small_batch)
        est_var = (sq_norm_small_batch - sq_norm_large_batch) / (
            1 / n_small_batch - 1 / n_large_batch)
        self.ema_sq_norm = (self.beta * self.ema_sq_norm
                            + (1 - self.beta) * est_sq_norm)
        self.ema_var = self.beta * self.ema_var + (1 - self.beta) * est_var
        self.beta_cumprod *= self.beta
        self.gradient_noise_scale = max(self.ema_var, self.eps) / max(
            self.ema_sq_norm, self.eps)
        return self.gradient_noise_scale

    def get_gns(self) -> float:
        return self.gradient_noise_scale

    def get_stats(self) -> Tuple[float, float]:
        """Debiased EMA estimates (ref: k_diffusion/gns.py:93-99)."""
        return (self.ema_sq_norm / (1 - self.beta_cumprod),
                self.ema_var / (1 - self.beta_cumprod))
