#!/usr/bin/env python
"""Monte-Carlo per-sigma posterior variance estimation CLI (PyTorch port of
`kdip_tpu/cli/analytic_variance.py:20-96`; ref: analytic_variance.py:
47-149).

    python -m kdip_tpu_torch.cli.analytic_variance --checkpoint model.pt \
        --config configs/test_imagenet.json \
        --logdir runs/analytic_variance/imagenet [--device cpu]

For each of `--num-sigmas` Karras sigmas, estimates E||x0 - D(x0 + sigma
eps)||^2 over the first `--data-fraction` of the config's image folder
(resized to the model's input size), and saves {sigmas, mse_list, errors}
as `recon_mse.npz` and `recon_mse.pt` for the 'analytic' posterior
covariance (condition/condition.py:250-256; the guided CLI reads either
through the config's `recon_mse` key). The flags, defaults and artefacts
are `kdip_tpu`'s, with one more: `--device` (default `cuda`; the CPU only
when asked for). The noise of sigma i and batch j comes from a
torch.Generator seeded from numpy's SeedSequence([seed, i, j]), so a
`--resume`d table equals an uninterrupted one.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from .. import ckpt, config as kconfig, precond, schedules, train, weights
from ..data import FolderOfImages
from .sample_condition import _device


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--num-sigmas", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--resume", action="store_true",
                   help="continue from <logdir>/recon_mse.jsonl (per-sigma "
                        "journal; noise seeded by (seed, sigma, batch) makes "
                        "the resumed table identical to an uninterrupted "
                        "run)")
    p.add_argument("--per-sample-map", action="store_true",
                   help="batch-1 forwards over the batch, on the same noise")
    p.add_argument("--data-fraction", type=float, default=0.01)
    p.add_argument("--logdir", type=str, default="runs/analytic_variance")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; pass cpu "
                        "to run on the CPU)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = _device(args.device)

    config = kconfig.load_config(args.config)
    model_config = config["model"]
    model, tables = kconfig.make_openai_model(model_config, device=dev)
    ckpt.load_strict(model, ckpt.load_torch_checkpoint(args.checkpoint))
    if args.dtype == "bfloat16":
        # one cast of the torso; the GroupNorm parameters stay float32
        weights.precast_inference(model)
    model.eval().requires_grad_(False)
    size = model_config["input_size"][0]

    def model_apply(x_scaled, t):  # eps: the first C of the 2C outputs
        return model(x_scaled, t)[:, :x_scaled.shape[1]]

    denoise = precond.make_discrete_eps_denoiser(model_apply,
                                                 tables.log_sigmas)
    if args.per_sample_map:
        batched = denoise

        def denoise(x, sigma):
            return torch.cat([batched(x[i:i + 1], sigma)
                              for i in range(x.shape[0])])

    sigmas = schedules.get_sigmas_karras(
        args.num_sigmas, model_config["sigma_min"],
        model_config["sigma_max"]).numpy()[:-1]

    dataset = FolderOfImages(config["dataset"]["location"], size=size)
    n_use = max(1, int(len(dataset) * args.data_fraction))
    # kdip_tpu decodes every batch and keeps these; the rest go undecoded
    batches = [torch.from_numpy(b).to(dev) for b in itertools.islice(
        dataset.batches(args.batch_size), max(1, n_use // args.batch_size))]

    os.makedirs(args.logdir, exist_ok=True)  # before the journal opens
    out = train.analytic_variance(
        denoise, batches, sigmas, args.seed,
        journal_path=(os.path.join(args.logdir, "recon_mse.jsonl")
                      if args.resume else None))
    np.savez(os.path.join(args.logdir, "recon_mse.npz"),
             **{k: v.numpy() for k, v in out.items()})
    torch.save(out, os.path.join(args.logdir, "recon_mse.pt"))
    print(f"saved recon_mse for {len(sigmas)} sigmas to {args.logdir}")
    return out


if __name__ == "__main__":
    main()
