"""Everything a run feeds the program, made from --seed on the device: the
weights (one draw for all parameters, rounded to bfloat16 so that the
program's cast to its serving precision is exact and the reference sees the
same numbers), the images of every solve, the operator's draw, the
measurements, and the sampler's initial and churn noise. The same seed gives
the same inputs; the reference regenerates them from the seed."""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

import torch


def mix(*parts) -> int:
    """A 63-bit seed from the run's seed and the names of a draw."""
    h = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(*parts))


def weights(shapes: Iterable[Tuple[str, torch.Size]], norms: set, seed: int,
            std: float, device) -> Dict[str, torch.Tensor]:
    """Every parameter from one normal draw on `device`: std * N(0, 1), the
    GroupNorm scales (`norms`) 1 + std * N(0, 1), in name order; each value
    rounded to bfloat16 and kept in float32. Zero-initialised layers of the
    published model (the output convs) are drawn too, or eps would be 0."""
    shapes = sorted(shapes)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    flat = torch.randn(total, generator=generator(device, seed, "weights"),
                       device=device).mul_(std)
    out, off = {}, 0
    for name, shape in shapes:
        n = int(torch.Size(shape).numel())
        out[name] = flat[off:off + n].view(shape)
        if name in norms:
            out[name].add_(1.0)
        off += n
    flat.copy_(flat.to(torch.bfloat16))
    return out


def images(seed: int, solve: int, shape, device) -> torch.Tensor:
    """The solve's B distinct images, uniform in [-1, 1]."""
    g = generator(device, seed, "images", solve)
    return torch.rand(shape, generator=g, device=device) * 2 - 1


def noise(seed: int, what: str, solve: int, step: int, shape,
          device) -> torch.Tensor:
    """A standard normal draw of a solve: its measurement noise
    ("measure"), its initial noise ("init") or a step's churn ("churn")."""
    g = generator(device, seed, what, solve, step)
    return torch.randn(shape, generator=g, device=device)
