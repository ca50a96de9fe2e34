"""Deterministic Brownian-motion noise for the SDE samplers (PyTorch port of
`kdip_tpu/brownian.py`; ref: k_diffusion/sampling.py:65-114, which uses
torchsde's BrownianTree).

W(t) is a virtual Brownian path built by dyadic bisection (the Levy bridge),
as `kdip_tpu` builds it: W(1) ~ N(0, t_span), then each midpoint of a
bracketing interval [a, b] is (W(a) + W(b)) / 2 + N(0, (b - a) t_span / 4),
descending `depth` levels toward the query and bridging the rest linearly.
Each node's draw comes from its own torch.Generator, seeded with a 64-bit
state of numpy's SeedSequence([seed, node id]) (node 0 is W(1); a midpoint's
id is its heap path + 1, as `kdip_tpu` folds it into its key). So W(t) is a
pure function of (seed, t): nested, repeated and out-of-order queries agree.
The descent is decided on the host, in float32 as `kdip_tpu` decides it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def node_seed(seed: int, node: int) -> int:
    """The 64-bit generator seed of a tree node."""
    return int(np.random.SeedSequence([seed, node]).generate_state(
        1, np.uint64)[0])


class BrownianTreeNoiseSampler:
    """`__call__(sigma, sigma_next)` returns unit-variance noise
    `(W(t1) - W(t0)) / sqrt(|t1 - t0|)`, t = transform(sigma), over a path W
    consistent for every query (ref: k_diffusion/sampling.py:92-114).
    Each W query draws 1 + depth tensors of `shape` on `device`; `queries`
    counts them."""

    def __init__(self, shape, sigma_min, sigma_max, seed: int,
                 device="cuda", dtype=torch.float32,
                 transform: Callable = lambda s: s, depth: int = 24):
        self.shape = tuple(shape)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self.transform = transform
        self.depth = depth
        t0 = float(transform(sigma_min))
        t1 = float(transform(sigma_max))
        self.t_lo, self.t_hi = (t0, t1) if t0 < t1 else (t1, t0)
        self.queries = 0

    def _draw(self, node: int, std) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(
            node_seed(self.seed, node))
        return torch.randn(self.shape, generator=g, device=self.device,
                           dtype=self.dtype) * float(std)

    def w(self, t) -> torch.Tensor:
        """W at t (float32; clipped into [t_lo, t_hi])."""
        self.queries += 1
        f32 = np.float32
        u = (f32(t) - f32(self.t_lo)) / f32(self.t_hi - self.t_lo)
        u = min(max(u, f32(0)), f32(1))
        span = f32(self.t_hi - self.t_lo)
        a, b = f32(0), f32(1)
        wa = torch.zeros(self.shape, device=self.device, dtype=self.dtype)
        wb = self._draw(0, np.sqrt(span))
        path = 0
        for _ in range(self.depth):
            mid, half = (a + b) / f32(2), (b - a) / f32(2)
            go_right = bool(u >= mid)
            wm = (wa + wb) / 2 + self._draw(path + 1,
                                            np.sqrt(half * span / f32(2)))
            if go_right:
                a, wa = mid, wm
            else:
                b, wb = mid, wm
            path = path * 2 + int(go_right) + 1
        frac = (u - a) / (b - a) if b > a else f32(0)
        return wa + (wb - wa) * float(frac)

    def __call__(self, sigma, sigma_next) -> torch.Tensor:
        t0 = np.float32(self.transform(np.float32(sigma)))
        t1 = np.float32(self.transform(np.float32(sigma_next)))
        return (self.w(t1) - self.w(t0)) / float(np.sqrt(np.abs(t1 - t0)))
