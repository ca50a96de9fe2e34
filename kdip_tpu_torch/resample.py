"""Timestep schedule samplers for discrete-time DDPM training (PyTorch
port's copy of `kdip_tpu/resample.py`; ref: guided_diffusion/resample.py).

Uniform sampling and loss-second-moment importance sampling, in numpy on
the host: timesteps and weights come from a `np.random.RandomState`, so
the port and `kdip_tpu` draw the same `t` and weights from one seed.
Across the ranks of a process group each rank holds only its block's
losses: `update_with_local_losses(..., group=)` all-gathers every rank's
(t, loss) pairs, padded to the largest count, in rank order, as the
reference does (resample.py:83-104), so the update sees the global batch's
pairs in the order one process would. Without a group the local losses are
all the losses.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """(ref: resample.py:10-24)"""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    elif name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    else:
        raise NotImplementedError(f"unrecognized schedule sampler {name!r}")


class ScheduleSampler(ABC):
    """(ref: resample.py:27-58)"""

    @abstractmethod
    def weights(self) -> np.ndarray:
        ...

    def sample(self, batch_size: int, rng: np.random.RandomState):
        """Importance-samples timesteps; returns (t [B] int32, weights [B]
        float32), numpy."""
        w = self.weights()
        p = w / w.sum()
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)


class UniformSampler(ScheduleSampler):
    """(ref: resample.py:61-67)"""

    def __init__(self, num_timesteps: int):
        self._weights = np.ones(num_timesteps)

    def weights(self):
        return self._weights


class LossAwareSampler(ScheduleSampler):
    """(ref: resample.py:70-121). update_with_all_losses consumes the
    batch's (t, loss) pairs."""

    def update_with_local_losses(self, local_ts, local_losses, group=None):
        if group is not None:
            import torch

            from .parallel.sharding import all_gather_blocks

            def gather(a, dtype):
                return torch.cat(all_gather_blocks(
                    torch.as_tensor(np.asarray(a, dtype)), group)).numpy()
            local_ts = gather(local_ts, np.int64)
            local_losses = gather(local_losses, np.float64)
        self.update_with_all_losses(np.asarray(local_ts),
                                    np.asarray(local_losses))

    @abstractmethod
    def update_with_all_losses(self, ts, losses):
        ...


class LossSecondMomentResampler(LossAwareSampler):
    """(ref: resample.py:124-154)"""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term],
                                      dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=int)

    def weights(self):
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        weights = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        weights /= np.sum(weights)
        weights *= 1 - self.uniform_prob
        weights += self.uniform_prob / len(weights)
        return weights

    def update_with_all_losses(self, ts, losses):
        for t, loss in zip(ts, losses):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self):
        return (self._loss_counts == self.history_per_term).all()
