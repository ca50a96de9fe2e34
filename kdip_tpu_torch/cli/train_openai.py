#!/usr/bin/env python
"""Variance-head fine-tuning CLI, the DWT/DCT-Var training (PyTorch port of
`kdip_tpu/cli/train_openai.py:24-250`; ref: train_openai.py:35-143).

    python -m kdip_tpu_torch.cli.train_openai --checkpoint model.pt \
        --config configs/train_ffhq_dwt.json --logdir runs/x [--device cpu]

Loads a pretrained OpenAI UNet `.pt` into the torso, attaches a fresh
`out_cov` variance head and fine-tunes the whole model in float32 with the
dual NLL loss (spatial and ortho domain) under Karras augmentation, with
the EMA warmup and optional dpmpp_2m sample previews. The flags, defaults
and artefacts are `kdip_tpu`'s (`train_log.csv`, TensorBoard scalars under
`tb/`, `state_{step}` with the EMA weights, `train_state_latest` for
`--resume`, `preview_{step}.png`), with one more: `--device` (default
`cuda`; the CPU only when asked for). The checkpoints are torch files
(`state_{step}.pt`: the EMA ADMUNetV2 state dict, which `ckpt.load_v2` and
the guided CLI's `--v2 --checkpoint` load; `train_state_latest.pt`); an
orbax directory is refused. Step s draws its sigma and noise from a
torch.Generator seeded from numpy's SeedSequence([seed, s]); the batches
of an epoch that starts at step s are shuffled with seed + s, as in
`kdip_tpu`. So a run resumed where an epoch starts continues exactly as
the uninterrupted run. `--num-workers` decodes with a thread pool.
The CLI leaves torch's TF32 switches as they are: by PyTorch's defaults
cuDNN's float32 convolutions may use TF32 on the card and matmuls do not.

Launched by torchrun (`torchrun --nproc_per_node=N -m
kdip_tpu_torch.cli.train_openai ...`) it is data-parallel over the N
ranks, one card each (`kdip_tpu` runs data-parallel over every local
device): each rank takes its block of the global batch and of its sigma
and noise draws, the gradients are averaged over the ranks before Adam,
and rank 0 alone writes the logs and checkpoints; `--resume` reads on rank
0 and broadcasts. --per-sample-map applies at one rank only. `kdip_tpu`
shrinks its device count until it divides the batch; ranks cannot sit
out of their group, so the port refuses a --batch-size the world size
does not divide.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import signal
import time

import torch

from .. import ckpt, config as kconfig, precond, samplers, schedules, train
from ..parallel import dist as pdist
from ..data import (FolderOfImages, KarrasAugmentationPipeline,
                    augment_batch, to_uint8_image, write_png)
from ..models import adm
from ..ops.transforms import OrthoTransform
from ..tfevents import EventFileWriter
from ..utils import EMAWarmup, make_sample_density, seeded_generator
from .sample_condition import _device


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="pretrained OpenAI UNet .pt")
    p.add_argument("--batch-size", type=int, default=12)
    p.add_argument("--accum", type=int, default=1,
                   help="gradient accumulation steps")
    p.add_argument("--per-sample-map", dest="per_sample_map",
                   action="store_true", default=True,
                   help="per-example backward passes summed into one "
                        "gradient (the same update, one example's "
                        "activations in memory at a time)")
    p.add_argument("--no-per-sample-map", dest="per_sample_map",
                   action="store_false")
    p.add_argument("--num-workers", type=int, default=8,
                   help="decode threads for the input pipeline (ref: "
                        "train_openai.py:43 DataLoader num_workers; 0 = "
                        "synchronous loading)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--resume", action="store_true",
                   help="continue from <logdir>/train_state_latest.pt "
                        "(params, optimizer, EMA and accumulator, written "
                        "at every save)")
    p.add_argument("--preview-every", type=int, default=0,
                   help="if >0, save a dpmpp_2m EMA sample grid every N "
                        "steps (ref: train_openai.py:106-117)")
    p.add_argument("--preview-steps", type=int, default=50)
    p.add_argument("--logdir", type=str, default="runs/train_openai")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; pass cpu "
                        "to run on the CPU)")
    return p


def init_out_cov_(conv: torch.nn.Conv2d, seed: int) -> None:
    """flax nn.Conv's default init, as `kdip_tpu`'s model.init gives the
    head: a LeCun-normal kernel (a normal truncated to +-2 std, std
    sqrt(1 / fan_in) / 0.8796...) and a zero bias, drawn on the CPU from
    seeded_generator(cpu, seed), so the CPU and the card start alike."""
    fan_in = conv.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    w = torch.empty(conv.weight.shape)
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                generator=seeded_generator("cpu", seed))
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.zero_()


def _save_preview(ema_model, tables, size, model_config, args, step, dev):
    """EMA unconditional sample grid via dpmpp_2m, 4 samples side by side
    (ref: train_openai.py:99-117); the initial noise from
    seeded_generator(dev, step)."""
    def model_apply(x_scaled, t):
        return ema_model(x_scaled, t)[0]

    denoise = precond.make_discrete_eps_denoiser(model_apply,
                                                 tables.log_sigmas)
    sigmas = schedules.get_sigmas_karras(args.preview_steps,
                                         model_config.get("sigma_min", 1e-2),
                                         model_config.get("sigma_max", 80.0))
    x = torch.randn((4, 3, size, size), generator=seeded_generator(dev, step),
                    device=dev) * float(sigmas[0])
    with torch.no_grad():
        out = samplers.sample_dpmpp_2m(denoise, x, sigmas)
    write_png(os.path.join(args.logdir, f"preview_{step}.png"),
              to_uint8_image(torch.cat(list(out), dim=2)))


def main(argv=None) -> train.TrainState:
    args = build_argparser().parse_args(argv)
    dev = _device(args.device)
    group = None
    if pdist.setup_dist(device=dev.type):
        group = torch.distributed.group.WORLD
        dev = pdist.dev() if dev.type == "cuda" else dev
    world, lead = pdist.get_world_size(group), pdist.get_rank(group) == 0
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} does not divide "
                         f"over the {world} ranks")

    config = kconfig.load_config(args.config)
    model_config = config["model"]
    unet, tables = kconfig.make_openai_model(model_config, device=dev)
    # eval(): no live dropout, as kdip_tpu runs this fine-tune's UNet
    # deterministic (its train_openai.py:125); gradients flow all the same
    model = adm.ADMUNetV2(unet).eval()
    size = model_config["input_size"][0]

    # fresh head, pretrained torso (ref: train_openai.py:119-129)
    init_out_cov_(model.out_cov, args.seed)
    ckpt.load_strict(unet, pdist.load_state_dict(args.checkpoint,
                                                 group=group))
    pdist.sync_params(model, group)

    ortho_tf = OrthoTransform(model_config.get("ortho_tf_type"))
    density = make_sample_density(
        model_config, sigma_data=model_config.get("sigma_data", 1.0),
        sigma_min=model_config.get("sigma_min", 1e-2),
        sigma_max=model_config.get("sigma_max", 80.0))

    def loss_fn(x0, noise, sigma):
        return train.openai_v2_loss(model, x0, noise, sigma,
                                    tables.log_sigmas, ortho_tf)

    state = train.TrainState(model, args.lr, args.accum)
    ema_sched = EMAWarmup(power=config["ema_sched"]["power"],
                          max_value=config["ema_sched"]["max_value"])
    latest = os.path.join(args.logdir, "train_state_latest.pt")
    if args.resume:
        # kdip_tpu's state is an orbax directory: load_checkpoint refuses it
        orbax = os.path.join(args.logdir, "train_state_latest")
        path = orbax if os.path.isdir(orbax) else latest
        saved = pdist.read_if_present(path, ckpt.load_checkpoint, group)
        if saved is not None:
            state.load_state_dict(saved["train_state"])
            # the EMA warmup fast-forwarded to the saved step
            ema_sched.last_epoch = int(saved["ema_sched_last_epoch"])
            print(f"resumed from {latest} at step {state.step}", flush=True)
    start_step = state.step

    # per-sample-map serializes the batch: a win at one rank only
    step_fn = train.make_train_step(
        loss_fn, density,
        per_sample_map=args.per_sample_map and args.batch_size > 1
        and world == 1, group=group)
    aug = KarrasAugmentationPipeline(
        a_prob=model_config.get("augment_prob", 0.0))
    dataset = FolderOfImages(config["dataset"]["location"], size=size)
    if len(dataset) < args.batch_size:
        # with drop_last, a smaller folder gives no batch and no step ends
        raise SystemExit(f"{len(dataset)} images under "
                         f"{config['dataset']['location']}, fewer than "
                         f"--batch-size {args.batch_size}")

    if lead:
        os.makedirs(args.logdir, exist_ok=True)
        log_file = open(os.path.join(args.logdir, "train_log.csv"), "a",
                        newline="")
        logger = csv.writer(log_file)
        logger.writerow(["step", "loss", "ema_decay", "time"])
        # TensorBoard scalars (ref: train_openai.py:70 TensorBoardLogger)
        tb = EventFileWriter(os.path.join(args.logdir, "tb"))

    # A SIGTERM (a preemption) requests a clean stop: the loop saves
    # train_state_latest and returns, so a --resume relaunch continues
    stop_requested = {"flag": False}

    def _on_sigterm(signum, frame):
        stop_requested["flag"] = True

    try:
        previous_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        installed = True
    except ValueError:
        installed = False  # not the main thread (e.g. some test runners)

    def save(step):
        if lead:
            ckpt.save_checkpoint(os.path.join(args.logdir,
                                              f"state_{step}.pt"),
                                 state.ema.state_dict())
            ckpt.save_checkpoint(latest, {
                "train_state": state.state_dict(),
                "ema_sched_last_epoch": ema_sched.last_epoch})
        pdist.barrier("train_openai_save")

    step = start_step
    t0 = time.time()
    try:
        while step < args.max_steps:
            for batch in dataset.batches(args.batch_size, drop_last=True,
                                         shuffle=True, seed=args.seed + step,
                                         num_workers=args.num_workers):
                if step >= args.max_steps:
                    break
                aug_imgs, _, _ = augment_batch(aug, batch, seed=step)
                decay = ema_sched.get_value()
                loss = step_fn(state, torch.from_numpy(aug_imgs).to(dev),
                               decay,
                               generator=seeded_generator(dev, args.seed,
                                                          step))
                ema_sched.step()
                step += 1
                if lead and (step % 50 == 0 or step == 1):
                    loss = float(loss)
                    print(f"step {step}: loss {loss:.4f} ema {decay:.5f}",
                          flush=True)
                    logger.writerow([step, loss, decay, time.time() - t0])
                    log_file.flush()
                    tb.add_scalars(step, [("train/loss", loss),
                                          ("train/ema_decay", decay)])
                if (lead and args.preview_every
                        and step % args.preview_every == 0):
                    _save_preview(state.ema, tables, size, model_config,
                                  args, step, dev)
                if stop_requested["flag"]:
                    raise KeyboardInterrupt
                if step % args.save_every == 0 or step == args.max_steps:
                    save(step)
    except KeyboardInterrupt:
        # graceful interrupt / preemption: keep the EMA weights and the
        # whole resumable state (ref: sample_condition_openai.py:214-217)
        why = "preempted" if stop_requested["flag"] else "interrupted"
        print(f"{why} at step {step} — saving checkpoint", flush=True)
        if step > 0:
            save(step)
    finally:
        if lead:
            log_file.close()
            tb.close()
        if installed:  # main() may run inside a caller's process
            signal.signal(signal.SIGTERM, previous_sigterm)
    print(f"done: {step} steps in {time.time() - t0:.0f}s")
    return state


if __name__ == "__main__":
    main()
