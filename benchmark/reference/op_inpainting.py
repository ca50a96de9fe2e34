"""Inpainting (measurements.py:202-244 of the source repository): A is a
fixed 0/1 mask, y = mask * (x + sigma_s n). The guided solve's pieces as
`guided.guided_x0` takes them (condition.py:317-348): the residual
b = mask y - mask x0_mean, the system s^2 v + mask C(v), its closed form at
a scalar variance, and u itself in image space."""

import numpy as np
import torch

F32 = np.float32


class Inpainting:
    def __init__(self, y: torch.Tensor, mask: torch.Tensor, sigma_s: float):
        self.y, self.mask = y, mask
        self.s2 = float(max(F32(sigma_s), F32(0.001)) ** 2)

    def residual(self, x0_mean):
        return self.mask * self.y - self.mask * x0_mean

    def matvec(self, cov):
        def mv(v):
            return self.s2 * v + self.mask * cov(v)
        return mv

    def closed(self, b, var: float):
        return b / float(F32(self.s2) + F32(var))

    def adjoint(self, u):
        return u
