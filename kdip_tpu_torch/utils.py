"""Training utilities: the EMA and its warmup, LR schedules, sigma sample
densities and the CSV logger (PyTorch port of `kdip_tpu/utils.py:76-208,
290-301`; ref: k_diffusion/utils.py:85-311, k_diffusion/config.py:110-136).

Each density is a map from its uniform or normal draws to sigma
(`*_from`), beside a `rand_*` that makes those draws from a
`torch.Generator` on the generator's device; so a test can feed a map
`kdip_tpu`'s own draws. `make_sample_density` returns
fn(shape, generator) -> sigma, float32. `seeded_generator` is the port's
counterpart of folding indices into a jax key.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A torch.Generator on `device` seeded from
    numpy.random.SeedSequence(entropy): the port's counterpart of
    fold_in(fold_in(key(seed), i), j), independent of any earlier draw."""
    state = np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------

@torch.no_grad()
def ema_update(ema_model: torch.nn.Module, model: torch.nn.Module,
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, parameter by
    parameter (ref: k_diffusion/utils.py:85-101). decay and 1 - decay are
    float32, as in `kdip_tpu`'s jitted step."""
    d = np.float32(decay)
    one_minus = float(np.float32(1) - d)
    for e, p in zip(ema_model.parameters(), model.parameters()):
        e.mul_(float(d)).add_(p * one_minus)


class EMAWarmup:
    """Inverse-power EMA decay warmup (ref: k_diffusion/utils.py:104-151).

    value(step) = 1 - (1 + step/inv_gamma)^-power, clamped to
    [min_value, max_value]."""

    def __init__(self, inv_gamma=1.0, power=1.0, min_value=0.0,
                 max_value=1.0, start_at=0, last_epoch=0):
        self.inv_gamma = inv_gamma
        self.power = power
        self.min_value = min_value
        self.max_value = max_value
        self.start_at = start_at
        self.last_epoch = last_epoch

    def get_value(self):
        epoch = max(0, self.last_epoch - self.start_at)
        value = 1 - (1 + epoch / self.inv_gamma) ** -self.power
        return 0.0 if epoch < 0 else min(self.max_value,
                                         max(self.min_value, value))

    def step(self):
        self.last_epoch += 1


# ---------------------------------------------------------------------------
# LR schedules (step -> multiplier)
# ---------------------------------------------------------------------------

def inverse_lr(inv_gamma=1.0, power=1.0, warmup=0.0, final_lr=0.0
               ) -> Callable:
    """InverseLR (ref: k_diffusion/utils.py:152-190)."""
    def schedule(step):
        lr_mult = (1 + step / inv_gamma) ** -power
        w = 1 - warmup ** (step + 1) if warmup else 1.0
        return w * max(final_lr, lr_mult)
    return schedule


def exponential_lr(num_steps, decay=0.5, warmup=0.0, final_lr=0.0
                   ) -> Callable:
    """ExponentialLR (ref: k_diffusion/utils.py:193-231)."""
    def schedule(step):
        lr_mult = decay ** (step / num_steps)
        w = 1 - warmup ** (step + 1) if warmup else 1.0
        return w * max(final_lr, lr_mult)
    return schedule


# ---------------------------------------------------------------------------
# Sigma sample densities (ref: k_diffusion/utils.py:234-272)
# ---------------------------------------------------------------------------

def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def _uniform(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def _between(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """A [0, 1) uniform scaled to [lo, hi), as jax.random.uniform's minval
    and maxval scale it: the bounds and their span in float32."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


def log_normal_from(n: torch.Tensor, loc=0.0, scale=1.0) -> torch.Tensor:
    return torch.exp(n * scale + loc)


def rand_log_normal(shape, generator, loc=0.0, scale=1.0) -> torch.Tensor:
    return log_normal_from(_normal(shape, generator), loc, scale)


def _logistic_cdf(x: float) -> float:
    return 1 / (1 + math.exp(-x))


def log_logistic_from(u: torch.Tensor, loc=0.0, scale=1.0, min_value=0.0,
                      max_value=float("inf")) -> torch.Tensor:
    min_cdf = (_logistic_cdf((math.log(min_value) - loc) / scale)
               if min_value > 0 else 0.0)
    max_cdf = (_logistic_cdf((math.log(max_value) - loc) / scale)
               if max_value != float("inf") else 1.0)
    u = _between(u, min_cdf, max_cdf)
    return torch.exp(torch.logit(u) * scale + loc)


def rand_log_logistic(shape, generator, loc=0.0, scale=1.0, min_value=0.0,
                      max_value=float("inf")) -> torch.Tensor:
    return log_logistic_from(_uniform(shape, generator), loc, scale,
                             min_value, max_value)


def log_uniform_from(u: torch.Tensor, min_value, max_value) -> torch.Tensor:
    return torch.exp(_between(u, math.log(min_value), math.log(max_value)))


def rand_log_uniform(shape, generator, min_value, max_value) -> torch.Tensor:
    return log_uniform_from(_uniform(shape, generator), min_value, max_value)


def v_diffusion_from(u: torch.Tensor, sigma_data=1.0, min_value=0.0,
                     max_value=float("inf")) -> torch.Tensor:
    min_cdf = math.atan(min_value / sigma_data) * 2 / math.pi
    max_cdf = (math.atan(max_value / sigma_data) * 2 / math.pi
               if max_value != float("inf") else 1.0)
    return torch.tan(_between(u, min_cdf, max_cdf) * math.pi / 2) * sigma_data


def rand_v_diffusion(shape, generator, sigma_data=1.0, min_value=0.0,
                     max_value=float("inf")) -> torch.Tensor:
    return v_diffusion_from(_uniform(shape, generator), sigma_data,
                            min_value, max_value)


def rand_cosine(shape, generator, logsnr_min=-15.0, logsnr_max=15.0,
                sigma_data=1.0) -> torch.Tensor:
    """The 'cosine' density: v-diffusion's, unbounded, as `kdip_tpu`'s
    rand_cosine is (make_sample_density bounds it by sigma_min/max)."""
    return rand_v_diffusion(shape, generator, sigma_data=sigma_data)


def split_log_normal_from(n: torch.Tensor, u: torch.Tensor, loc, scale_1,
                          scale_2) -> torch.Tensor:
    n = n.abs()
    ratio = scale_1 / (scale_1 + scale_2)
    return torch.exp(torch.where(u < ratio, loc - n * scale_1,
                                 loc + n * scale_2))


def rand_split_log_normal(shape, generator, loc, scale_1, scale_2
                          ) -> torch.Tensor:
    n = _normal(shape, generator)
    return split_log_normal_from(n, _uniform(shape, generator), loc, scale_1,
                                 scale_2)


def make_sample_density(config: Dict, sigma_data: float = 1.0,
                        sigma_min: float = 1e-3, sigma_max: float = 1e3
                        ) -> Callable:
    """Density factory from a model config block (ref: k_diffusion/config.py:
    110-136; `kdip_tpu` utils.py:176-204). Returns fn(shape, generator) ->
    sigma on the generator's device."""
    sd = config.get("sigma_sample_density", {"type": "lognormal"})
    ty = sd["type"]
    if ty == "lognormal":
        loc = sd.get("mean", sd.get("loc", 0.0))
        scale = sd.get("std", sd.get("scale", 1.0))
        return lambda shape, g: rand_log_normal(shape, g, loc, scale)
    if ty == "loglogistic":
        loc = sd.get("loc", math.log(sigma_data))
        scale = sd.get("scale", 0.5)
        mn = sd.get("min_value", sigma_min)
        mx = sd.get("max_value", sigma_max)
        return lambda shape, g: rand_log_logistic(shape, g, loc, scale, mn,
                                                  mx)
    if ty == "loguniform":
        mn = sd.get("min_value", sigma_min)
        mx = sd.get("max_value", sigma_max)
        return lambda shape, g: rand_log_uniform(shape, g, mn, mx)
    if ty in ("v-diffusion", "cosine"):
        mn = sd.get("min_value", sigma_min)
        mx = sd.get("max_value", sigma_max)
        return lambda shape, g: rand_v_diffusion(shape, g, sigma_data, mn,
                                                 mx)
    if ty == "split-lognormal":
        loc = sd.get("mean", sd.get("loc", 0.0))
        s1 = sd.get("std_1", sd.get("scale_1", 1.0))
        s2 = sd.get("std_2", sd.get("scale_2", 1.0))
        return lambda shape, g: rand_split_log_normal(shape, g, loc, s1, s2)
    raise ValueError(f"Unknown sample density type {ty}")


class CSVLogger:
    """Append-mode CSV logger (ref: k_diffusion/utils.py:300-311): a new
    file starts with the column row."""

    def __init__(self, filename, columns):
        self.filename = Path(filename)
        self.columns = columns
        if self.filename.exists():
            self.file = open(self.filename, "a")
        else:
            self.file = open(self.filename, "w")
            self.write(*self.columns)

    def write(self, *args):
        print(*args, sep=",", file=self.file, flush=True)

    def close(self):
        self.file.close()
