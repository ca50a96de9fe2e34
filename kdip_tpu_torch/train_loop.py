"""Discrete-time DDPM training loop, guided-diffusion's TrainLoop (PyTorch
port of `kdip_tpu/train_loop.py`; ref: guided_diffusion/train_util.py:
22-301).

Microbatched forward and backward with the gradients' mean taken over a
macro step, loss-aware timestep sampling, a chain of EMA rates, the
gradient noise scale from the microbatch gradients, periodic checkpoints
and step-parsed resume, and KV logging through `logger`.

Data-parallel under `mesh` (a `parallel.sharding.make_mesh` DeviceMesh or
a process group): every rank reads the same global batches, makes the
global microbatch's draws (timesteps, q-sample noise, dropout masks) and
keeps its block of each microbatch; the float32 gradients and the loss
terms are averaged over the ranks (one all_reduce a microbatch, after the
bf16 -> float32 cast), the loss-aware sampler's update gathers every
rank's (t, loss), and every rank applies the same Adam step and EMAs. So
W ranks give the one-process loop's numbers, up to the order of float32
sums. Rank 0 writes the checkpoints and the logger's output; the ranks
meet at a barrier after each save, and a resume reads on rank 0 and
broadcasts.

Mixed precision as guided-diffusion's MixedPrecisionTrainer shapes it:
the model given is the float32 master. With `compute_dtype` (bfloat16 for
the ADM torso) a copy pre-cast by `weights.precast_inference` (GroupNorm
float32) runs the forward and backward; before each macro step the
masters are copied into it (`copy_` bumps each weight's version, so the
Winograd transform cache recomputes), and its gradients are cast to
float32 before they are summed. `kdip_tpu` trains float32 params through
a bf16 compute torso, whose gradient is the bf16 cotangent of each
param's cast: the same numbers. Adam (or AdamW, optax's decoupled decay,
under `weight_decay`), the lr annealing and the EMAs act on the masters.

The model is called as model(x_t, t) in train() mode, so its dropout is
live; its masks come from a generator seeded from `seed`, as does the
q-sample noise (or `noise_fn(step, micro)`), and the timesteps from
RandomState(seed), as in `kdip_tpu`. Checkpoints are torch files:
`model_{N}.pt` and `ema_{rate}_{N}.pt` are float32 state dicts under the
model's (guided-diffusion's) names, which the CLIs' `--checkpoint` reads,
and `opt_{N}.pt` the optimizer's; a resume restores params, optimizer,
EMAs and step, and restarts the draws from the seed, as `kdip_tpu` does.
`kdip_tpu`'s orbax directories are refused.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Callable, List, Optional

import numpy as np
import torch

from . import ckpt as ckpt_lib
from . import logger
from .parallel import dist as pdist
from .parallel import sharding
from .ddpm_sampling import training_losses
from .diffusion import DiffusionTables
from .models.layers import set_dropout_generator
from .resample import LossAwareSampler, ScheduleSampler, UniformSampler
from .utils import ema_update, seeded_generator
from .weights import precast_inference


def find_resume_checkpoint(logdir: str) -> Optional[str]:
    """The latest model checkpoint in logdir, `model_{N}.pt` (or a
    `kdip_tpu` orbax directory `model_{N}`, which loading refuses), by N
    (ref: train_util.py:258-292 parse_resume_step_from_filename)."""
    if not os.path.isdir(logdir):
        return None
    best = None
    best_step = -1
    for name in os.listdir(logdir):
        m = re.fullmatch(r"model_(\d+)(\.pt)?", name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(logdir, name)
    return best


class TrainLoop:
    """(ref: guided_diffusion/train_util.py:22-301; `kdip_tpu`
    train_loop.py:48-222)

    model: the float32 master, called as model(x_t, t) -> raw output (eps
    [+ variance values]); data: an iterator of [B, C, H, W] batches (numpy
    or tensors), moved to the model's device: the global batch, the same
    on every rank under `mesh` (data-parallel training over its ranks,
    which must divide batch_size and microbatch; see above)."""

    def __init__(self, *, model: torch.nn.Module, tables: DiffusionTables,
                 data, batch_size: int, microbatch: int = -1,
                 lr: float = 1e-4, ema_rate="0.9999", log_interval: int = 10,
                 save_interval: int = 10000, logdir: str = "runs/train",
                 schedule_sampler: Optional[ScheduleSampler] = None,
                 weight_decay: float = 0.0, lr_anneal_steps: int = 0,
                 loss_type: str = "mse", learn_sigma: bool = True,
                 resume: bool = True, mesh=None, seed: int = 0,
                 measure_gns: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 noise_fn: Optional[Callable] = None):
        self.mesh = mesh
        self.group = None if mesh is None else sharding.group_of(mesh)
        self.rank = pdist.get_rank(self.group)
        self.world = pdist.get_world_size(self.group)
        mb = microbatch if microbatch > 0 else batch_size
        if batch_size % self.world or mb % self.world:
            raise SystemExit(f"batch_size {batch_size} and microbatch {mb} "
                             f"must divide over the mesh's {self.world} "
                             "ranks")
        pdist.sync_params(model, self.group)
        self.model = model
        self.device = next(model.parameters()).device
        self.tables = tables
        self.data = data
        self.batch_size = batch_size
        self.microbatch = microbatch if microbatch > 0 else batch_size
        self.lr = lr
        self.ema_rate = ([ema_rate] if isinstance(ema_rate, float)
                         else [float(x) for x in str(ema_rate).split(",")])
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.logdir = logdir
        self.schedule_sampler = schedule_sampler or UniformSampler(
            tables.num_timesteps)
        self.lr_anneal_steps = lr_anneal_steps
        self.loss_type = loss_type
        self.learn_sigma = learn_sigma
        self.noise_fn = noise_fn
        # the timesteps' RandomState, the q-sample noise's generator and the
        # dropout masks' generator, all from the seed
        self.rng = np.random.RandomState(seed)
        self.generator = seeded_generator(self.device, seed, 0)
        self.dropout_generator = seeded_generator(self.device, seed, 1)

        self.step = 0
        self.params = list(model.parameters())
        if compute_dtype is None or compute_dtype == torch.float32:
            self.compute = model
        else:
            self.compute = precast_inference(copy.deepcopy(model),
                                             compute_dtype)
        self.compute.train()
        self.compute_params = list(self.compute.parameters())
        opt = torch.optim.AdamW if weight_decay else torch.optim.Adam
        self.opt = opt(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                       weight_decay=weight_decay)
        self.ema_models: List[torch.nn.Module] = [
            copy.deepcopy(model).requires_grad_(False)
            for _ in self.ema_rate]

        if resume:
            self._maybe_resume()

        # gradient noise scale (ref: k_diffusion/gns.py; the microbatch
        # gradients are the small-batch statistics)
        self.gns = None
        if measure_gns:
            if self.microbatch >= self.batch_size:
                raise ValueError("measure_gns needs microbatch < batch_size "
                                 "(two batch sizes to contrast)")
            from .gns import GradientNoiseScale
            self.gns = GradientNoiseScale()

    # lr annealing (ref: train_util.py:214-220)
    def _lr_schedule(self, step: int) -> float:
        if not self.lr_anneal_steps:
            return self.lr
        frac_done = min(step / self.lr_anneal_steps, 1.0)
        return self.lr * (1 - frac_done)

    @torch.no_grad()
    def _sync_compute(self) -> None:
        if self.compute is not self.model:
            for c, m in zip(self.compute_params, self.params):
                c.copy_(m)

    def micro_grads(self, micro: torch.Tensor, t: torch.Tensor,
                    weights: torch.Tensor, noise: torch.Tensor):
        """One microbatch's weighted mean loss (a 0-dim tensor), its loss
        terms (detached) and the gradient of the loss with respect to each
        master parameter, float32, through the compute model as it stands
        (its dropout drawn from self.dropout_generator)."""
        set_dropout_generator(self.compute, self.dropout_generator,
                              (self.rank, self.world))
        terms = training_losses(self.tables, self.compute, micro, t,
                                loss_type=self.loss_type,
                                learn_sigma=self.learn_sigma, noise=noise)
        loss = (terms["loss"] * weights).mean()
        grads = torch.autograd.grad(loss, self.compute_params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.to(torch.float32)
                 for g, p in zip(grads, self.params)]
        return (loss.detach(), {k: v.detach() for k, v in terms.items()},
                grads)

    def _noise(self, micro: torch.Tensor, i: int) -> torch.Tensor:
        if self.noise_fn is not None:
            return torch.as_tensor(self.noise_fn(self.step, i)).to(
                self.device, torch.float32)
        return torch.randn(micro.shape, generator=self.generator,
                           device=self.device, dtype=torch.float32)

    @staticmethod
    def _sq_norm(grads) -> float:
        return float(sum(torch.sum(g * g) for g in grads))

    def _block(self, x):
        return sharding.block(x, self.rank, self.world)

    def _dumpkvs(self):
        if self.rank == 0:
            logger.dumpkvs()
        else:  # rank 0 writes the logs: the others drop theirs
            logger.get_current().name2val.clear()
            logger.get_current().name2cnt.clear()

    def run_loop(self, max_steps: Optional[int] = None):
        """(ref: train_util.py:153-178). The DIFFUSION_TRAINING_TEST
        environment variable stops it after the first save, as
        train_util.py:164-166 does."""
        test_mode = bool(os.environ.get("DIFFUSION_TRAINING_TEST"))
        for batch in self.data:
            if max_steps is not None and self.step >= max_steps:
                break
            self.run_step(batch)
            if self.step % self.log_interval == 0:
                self._dumpkvs()
            if self.step % self.save_interval == 0:
                self.save()
                if test_mode:
                    return
        if max_steps is None or self.step % self.save_interval != 0:
            self.save()

    def run_step(self, batch):
        """One macro step: the microbatches' gradients, their mean, one
        optimizer update and the EMAs (ref: train_util.py:180-230
        forward_backward + optimize). Under a mesh the batch is the global
        one and each rank runs its block of every microbatch."""
        batch = torch.as_tensor(batch).to(self.device, torch.float32)
        self._sync_compute()
        total_grads = None
        n_micro = 0
        sq_small_sum = 0.0
        for i in range(0, batch.shape[0], self.microbatch):
            micro = batch[i:i + self.microbatch]
            t, weights = self.schedule_sampler.sample(micro.shape[0],
                                                      self.rng)
            noise = self._noise(micro, n_micro)
            t = self._block(torch.from_numpy(t).to(self.device, torch.int64))
            loss, terms, grads = self.micro_grads(
                self._block(micro), t,
                self._block(torch.from_numpy(weights).to(self.device)),
                self._block(noise))
            if isinstance(self.schedule_sampler, LossAwareSampler):
                self.schedule_sampler.update_with_local_losses(
                    t.cpu().numpy(), terms["loss"].cpu().numpy(), self.group)
            logged = {k: terms[k].mean() for k in ("vb", "mse") if k in terms}
            loss, *grads = pdist.mean_over_ranks(
                [loss] + grads + list(logged.values()), self.group)
            grads, logged = grads[:len(self.params)], dict(zip(
                logged, grads[len(self.params):]))
            if total_grads is None:
                total_grads = grads
            else:
                for a, g in zip(total_grads, grads):
                    a.add_(g)
            n_micro += 1
            if self.gns is not None:
                sq_small_sum += self._sq_norm(grads)
            logger.logkv_mean("loss", float(loss))
            for k, v in logged.items():
                logger.logkv_mean(k, float(v))
        grads = [g / n_micro for g in total_grads]
        if self.gns is not None and n_micro > 1:
            gns_val = self.gns.update(sq_small_sum / n_micro,
                                      self._sq_norm(grads), self.microbatch,
                                      self.batch_size)
            logger.logkv("gns", gns_val)
        self._apply_update(grads)
        self.step += 1
        logger.logkv("step", self.step)
        logger.logkv("samples", self.step * self.batch_size)

    @torch.no_grad()
    def _apply_update(self, grads) -> None:
        for group in self.opt.param_groups:
            group["lr"] = self._lr_schedule(self.step)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.opt.step()
        for p in self.params:
            p.grad = None
        for ema, rate in zip(self.ema_models, self.ema_rate):
            ema_update(ema, self.model, rate)

    def save(self):
        """(ref: train_util.py:232-255): model_N.pt, ema_{rate}_N.pt and
        opt_N.pt in logdir, written by rank 0; the ranks meet after it."""
        if self.rank == 0:
            self._write_checkpoints()
        if self.group is not None:
            pdist.barrier("train_loop_save")

    def _write_checkpoints(self):
        os.makedirs(self.logdir, exist_ok=True)
        ckpt_lib.save_checkpoint(
            os.path.join(self.logdir, f"model_{self.step}.pt"),
            self.model.state_dict())
        for rate, ema in zip(self.ema_rate, self.ema_models):
            ckpt_lib.save_checkpoint(
                os.path.join(self.logdir, f"ema_{rate}_{self.step}.pt"),
                ema.state_dict())
        ckpt_lib.save_checkpoint(
            os.path.join(self.logdir, f"opt_{self.step}.pt"),
            self.opt.state_dict())
        logger.log(f"saved checkpoint at step {self.step}")

    def _maybe_resume(self):
        """(ref: train_util.py:110-151): the params, the optimizer and the
        EMAs saved at the latest step, and the step; the draws restart from
        the seed, as `kdip_tpu`'s do."""
        def read(path):
            return pdist.read_if_present(path, ckpt_lib.load_checkpoint,
                                         self.group)
        model_ckpt = pdist.broadcast_object(
            find_resume_checkpoint(self.logdir), self.group)
        if model_ckpt is None:
            return
        step = int(re.search(r"\d+", os.path.basename(model_ckpt)).group())
        self.model.load_state_dict(read(model_ckpt))
        opt = read(os.path.join(self.logdir, f"opt_{step}.pt"))
        if opt is not None:
            self.opt.load_state_dict(opt)
        for rate, ema in zip(self.ema_rate, self.ema_models):
            sd = read(os.path.join(self.logdir, f"ema_{rate}_{step}.pt"))
            if sd is not None:
                ema.load_state_dict(sd)
        self.step = step
        logger.log(f"resumed from step {step}")
