"""Training: the EDM and dual-NLL losses, the train state and step, and the
analytic-variance job (PyTorch port of `kdip_tpu/train.py`; ref:
k_diffusion/layers.py:27-84, k_diffusion/external.py:145-159,
analytic_variance.py:47-139).

The losses take a model callable with its weights closed over and return
the per-example loss [B]. The step draws sigma and noise from a
`torch.Generator` (or takes them injected), backpropagates the batch mean,
or with `per_sample_map` one example at a time into the same gradients,
and applies optax's `adam` through `torch.optim.Adam`, under `--accum k`
as optax's `MultiSteps` (a running-mean accumulator, Adam every k-th
call), then updates the EMA on every call, as `kdip_tpu` does.
"""

from __future__ import annotations

import copy
import json
import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as tdist

from . import precond
from .ops.transforms import OrthoTransform
from .parallel import dist as pdist
from .parallel.sharding import block
from .schedules import append_dims
from .utils import ema_update, seeded_generator


def _mean_over_pixels(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def edm_loss(model_apply: Callable, x0, noise, sigma,
             sigma_data: float = 1.0, **kwargs) -> torch.Tensor:
    """Karras preconditioned denoising loss (ref: k_diffusion/layers.py:
    27-32). model_apply(x_scaled, sigma) -> model output."""
    c_skip, c_out, c_in = [append_dims(c, x0.ndim)
                           for c in precond.edm_scalings(sigma, sigma_data)]
    noised = x0 + noise * append_dims(sigma, x0.ndim)
    model_output = model_apply(noised * c_in, sigma, **kwargs)
    target = (x0 - c_skip * noised) / c_out
    return _mean_over_pixels((model_output - target) ** 2)


def simple_loss(denoise: Callable, x0, noise, sigma, **kwargs
                ) -> torch.Tensor:
    """L_simple through the full denoiser (ref: k_diffusion/layers.py:
    77-84)."""
    noised = x0 + noise * append_dims(sigma, x0.ndim)
    denoised = denoise(noised, sigma, **kwargs)
    eps = (noised - denoised) / append_dims(sigma, x0.ndim)
    return _mean_over_pixels((eps - noise) ** 2)


def _dual_nll(model_output, logvar, logvar_ot, target,
              ortho_tf: OrthoTransform) -> torch.Tensor:
    error = (model_output - target) ** 2
    error_ot = (ortho_tf(model_output) - ortho_tf(target)) ** 2
    losses = (error / torch.exp(logvar) + logvar
              + error_ot / torch.exp(logvar_ot) + logvar_ot)
    return _mean_over_pixels(losses)


def variance_loss(model_apply: Callable, x0, noise, sigma,
                  ortho_tf: OrthoTransform, sigma_data: float = 1.0,
                  **kwargs) -> torch.Tensor:
    """Dual NLL loss, spatial and ortho domain, for models with variance
    heads (ref: k_diffusion/layers.py:45-63). model_apply returns
    (model_output, logvar, logvar_ot)."""
    c_skip, c_out, c_in = [append_dims(c, x0.ndim)
                           for c in precond.edm_scalings(sigma, sigma_data)]
    noised = x0 + noise * append_dims(sigma, x0.ndim)
    model_output, logvar, logvar_ot = model_apply(noised * c_in, sigma,
                                                  **kwargs)
    target = (x0 - c_skip * noised) / c_out
    return _dual_nll(model_output, logvar, logvar_ot, target, ortho_tf)


def openai_v2_loss(model_apply_v2: Callable, x0, noise, sigma, log_sigmas,
                   ortho_tf: OrthoTransform, **kwargs) -> torch.Tensor:
    """The DWT/DCT-Var fine-tune objective (ref: k_diffusion/external.py:
    145-159): model_apply_v2(x_scaled, t) -> (eps, logvar, logvar_ot) with
    the discrete-eps scalings and the interpolated timestep; target =
    (x0 - noised) / c_out. Under "dwt" the transform of the output and of
    the target are the Haar kernel's forward launches on the card, and the
    output's backward its inverse."""
    c_out, c_in = [append_dims(c, x0.ndim)
                   for c in precond.eps_scalings(sigma)]
    noised = x0 + noise * append_dims(sigma, x0.ndim)
    t = precond.sigma_to_t(log_sigmas.to(sigma.device), sigma)
    model_output, logvar, logvar_ot = model_apply_v2(noised * c_in, t,
                                                     **kwargs)
    target = (x0 - noised) / c_out
    return _dual_nll(model_output, logvar, logvar_ot, target, ortho_tf)


# ---------------------------------------------------------------------------
# Train state / step
# ---------------------------------------------------------------------------

class TrainState:
    """The step count, the model, its Adam optimizer (optax.adam: b1 0.9,
    b2 0.999, eps 1e-8 outside the square root), the EMA model, and under
    accum > 1 optax.MultiSteps' gradient mean and mini-step."""

    def __init__(self, model: torch.nn.Module, lr: float, accum: int = 1):
        self.step = 0
        self.model = model
        self.params = list(model.parameters())
        self.ema = copy.deepcopy(model).requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.params, lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.accum = accum
        self.acc_grads = ([torch.zeros_like(p) for p in self.params]
                          if accum > 1 else None)
        self.mini_step = 0

    @torch.no_grad()
    def apply_gradients(self, ema_decay: float) -> None:
        """Consumes the parameters' .grad: Adam on it (under accum > 1, on
        the running mean acc + (g - acc) / (n + 1) of the last k calls,
        every k-th call), then the EMA at `ema_decay` on every call."""
        if self.acc_grads is None:
            self.optimizer.step()
        else:
            n = self.mini_step
            for a, p in zip(self.acc_grads, self.params):
                a.add_((p.grad - a) / (n + 1))
            if n + 1 == self.accum:
                for a, p in zip(self.acc_grads, self.params):
                    p.grad = a
                self.optimizer.step()
                for a in self.acc_grads:
                    a.zero_()
                self.mini_step = 0
            else:
                self.mini_step = n + 1
        for p in self.params:
            p.grad = None
        ema_update(self.ema, self.model, ema_decay)
        self.step += 1

    def state_dict(self) -> Dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "ema": self.ema.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "acc_grads": self.acc_grads, "mini_step": self.mini_step}

    def load_state_dict(self, sd: Dict) -> None:
        if ((sd["acc_grads"] is None) != (self.acc_grads is None)
                or sd["mini_step"] >= self.accum):
            raise SystemExit("--resume: the saved state was written with "
                             "another --accum")
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.ema.load_state_dict(sd["ema"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.acc_grads is not None:
            for a, s in zip(self.acc_grads, sd["acc_grads"], strict=True):
                a.copy_(s)
        self.mini_step = int(sd["mini_step"])


def make_train_step(loss_fn: Callable, sample_density: Callable,
                    per_sample_map: bool = False, group=None) -> Callable:
    """step(state, batch, ema_decay, generator=None, sigma=None,
    noise=None) -> the mean loss (a 0-dim tensor, not read on the host).

    loss_fn(x0, noise, sigma) -> per-example loss [B]. sigma [B] is drawn
    from `generator` by sample_density, then the noise, unless injected.
    per_sample_map runs one example at a time, each backward of loss_i / B
    adding into the same gradients: `kdip_tpu`'s scan (train.py:131-144),
    the same mean with one example's activations alive at a time.

    With a process group `group` the step is data-parallel over its ranks
    (`kdip_tpu`'s step on a dp-sharded batch): batch, sigma and noise are
    the global batch's, each rank takes its block, and the gradients and
    the loss are averaged over the ranks in one all_reduce before Adam, so
    every rank applies the global batch's update."""
    def step(state: TrainState, batch: torch.Tensor, ema_decay: float,
             generator: Optional[torch.Generator] = None,
             sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = batch.shape[0]
        if sigma is None:
            sigma = sample_density((B,), generator)
        if noise is None:
            noise = torch.randn(batch.shape, generator=generator,
                                device=generator.device, dtype=batch.dtype)
        sigma = sigma.to(batch.device, torch.float32)
        noise = noise.to(batch.device, batch.dtype)
        if group is not None:
            r, w = tdist.get_rank(group), tdist.get_world_size(group)
            batch, sigma, noise = (block(t, r, w)
                                   for t in (batch, sigma, noise))
            B = batch.shape[0]
        for p in state.params:
            p.grad = None
        if per_sample_map and B > 1:
            loss = torch.zeros((), device=batch.device)
            for i in range(B):
                li = loss_fn(batch[i:i + 1], noise[i:i + 1],
                             sigma[i:i + 1]).mean()
                (li / B).backward()
                loss = loss + li.detach() / B
        else:
            loss = loss_fn(batch, noise, sigma).mean()
            loss.backward()
            loss = loss.detach()
        if group is not None:
            loss = _mean_over_ranks(state.params, loss, group)
        state.apply_gradients(ema_decay)
        return loss
    return step


def _mean_over_ranks(params, loss: torch.Tensor, group) -> torch.Tensor:
    """Every parameter's .grad and the loss averaged over the group's
    ranks; returns the loss."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    *grads, loss = pdist.mean_over_ranks(grads + [loss.reshape(1)], group)
    for p, g in zip(params, grads):
        p.grad = g
    return loss[0]


# ---------------------------------------------------------------------------
# Analytic variance estimation (ref: analytic_variance.py:47-139)
# ---------------------------------------------------------------------------

@torch.no_grad()
def analytic_variance(denoise: Callable, data_batches, sigmas, seed: int,
                      journal_path: Optional[str] = None,
                      noise_fn: Optional[Callable] = None
                      ) -> Dict[str, torch.Tensor]:
    """Monte-Carlo per-sigma reconstruction MSE table (`kdip_tpu`
    train.py:162-224): for each sigma, mse = E ||x0 - D(x0 + sigma eps,
    sigma)||^2 / numel over the batches (a list, or a callable returning an
    iterable), err = std / sqrt(n batches) with the population std.

    The noise of sigma i and batch j is drawn from
    seeded_generator(x0's device, seed, i, j) (kdip_tpu folds i then j into
    its key), or is noise_fn(i, j, shape). With a journal, each finished
    sigma is appended as a JSON line and a rerun skips it, so a resumed
    table equals a fresh one; a journal from another sigma grid is refused.
    Returns float32 {'sigmas', 'mse_list', 'errors'} on the CPU for the
    'analytic' covariance (condition/condition.py:250-256)."""
    done = {}
    journal = None
    if journal_path:
        if os.path.exists(journal_path):
            with open(journal_path) as f:
                for line in f:
                    rec = json.loads(line)
                    done[rec["i"]] = rec
        journal = open(journal_path, "a")

    mses, errors = [], []
    try:
        for i, sigma in enumerate(sigmas):
            sigma = float(np.float32(sigma))
            if i in done:
                if abs(done[i]["sigma"] - sigma) > 1e-6 * (1 + abs(sigma)):
                    raise SystemExit(
                        f"journal {journal_path} entry {i} was computed at "
                        f"sigma={done[i]['sigma']}, current grid has "
                        f"{sigma}; use a fresh journal")
                mses.append(done[i]["mse"])
                errors.append(done[i]["err"])
                continue
            vals = []
            for j, x0 in enumerate(data_batches() if callable(data_batches)
                                   else data_batches):
                if noise_fn is not None:
                    eps = noise_fn(i, j, x0.shape).to(x0)
                else:
                    eps = torch.randn(
                        x0.shape, dtype=x0.dtype, device=x0.device,
                        generator=seeded_generator(x0.device, seed, i, j))
                hat = denoise(x0 + sigma * eps, sigma)
                vals.append(((hat - x0) ** 2).mean())
            vals = torch.stack(vals)
            mses.append(float(vals.mean()))
            errors.append(float(vals.std(correction=0)
                                / math.sqrt(len(vals))))
            if journal is not None:
                journal.write(json.dumps({"i": i, "sigma": sigma,
                                          "mse": mses[-1],
                                          "err": errors[-1]}) + "\n")
                journal.flush()
    finally:
        if journal is not None:
            journal.close()
    return {"sigmas": torch.tensor(np.asarray(sigmas, np.float32)),
            "mse_list": torch.tensor(mses, dtype=torch.float32),
            "errors": torch.tensor(errors, dtype=torch.float32)}
