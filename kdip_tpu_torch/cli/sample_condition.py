#!/usr/bin/env python
"""Guided posterior sampling CLI (PyTorch port of
`kdip_tpu/cli/sample_condition.py:46-432`; ref: sample_condition_openai.py
and, under --v2, sample_condition_openai_v2.py).

    python -m kdip_tpu_torch.cli.sample_condition --checkpoint model.pt \
        --config configs/test_ffhq.json \
        --operator-config configs/inpainting_config.yaml [--device cpu]

Loads a model config JSON, an operator YAML and a torch checkpoint, runs
guided sampling over a folder of test images, and writes per-image
metrics to a resumable journal (`metrics.jsonl`), `args.yaml` and
`avg_metrics.yaml` in the log dir. The flags, defaults and artefacts are
`kdip_tpu`'s, with one more: `--device` (default `cuda`; the CPU only when
asked for). A config of `"type": "image_v2"` runs the k-diffusion
native variance model (`models.kdiff`, float32 whatever --dtype says)
with the EDM preconditioning, its ortho basis from the config without
--v2, as `kdip_tpu`'s CLI does; "image_v1" and the "openai*" types run
the ADM UNet. Per-batch randomness comes from two torch.Generators seeded
from numpy's SeedSequence([seed, 2*start]) and ([seed, 2*start+1]), so a
--resume run reproduces what the uninterrupted run would have drawn.

`--dp` samples each batch data-parallel over the ranks of a process group,
one card each (`torchrun --nproc_per_node=N -m
kdip_tpu_torch.cli.sample_condition --dp --batch-size B ...`; N must
divide B): every rank makes the global batch's measurement and draws and
samples its block with the batched sampler (`kdip_tpu`'s --dp runs its
batched sampler on a sharded batch), whose joint CG sums its inner
products across the ranks (`parallel.sharding.make_sharded_sampler`), so
the samples are the one-process batched run's. Rank 0 gathers them and
alone writes args.yaml, the journal, the PNGs and the averages; the
checkpoint, and under --resume the journal, are read on rank 0 and
broadcast.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import ckpt, config as kconfig, diffusion, guidance, metrics
from .. import operators, sampling_api, weights
from ..data import FolderOfImages, to_uint8_image, write_png
from ..models import adm
from ..parallel import dist as pdist
from ..parallel import sharding
from ..utils import seeded_generator

LPIPS_NOTE = (
    "computed with converted weights; converter unvalidated against "
    "published lpips package outputs in this environment. To validate: "
    "check the weight files against kdip_tpu/manifests/lpips_vgg16.json "
    "(scripts/make_weight_manifests.py --check), convert them with "
    "kdip_tpu_torch.metrics.convert_lpips_weights(torch.load("
    "'vgg16-397923af.pth'), torch.load('lpips/weights/v0.1/vgg.pth')) and "
    "save the tree as the npz that --lpips-weights reads (np.savez("
    "'lpips_vgg.npz', params=np.array(tree, dtype=object))), which "
    "kdip_tpu_torch.weights.lpips_from_jax_params turns into the port's "
    "tensors, then compare kdip_tpu_torch.metrics.lpips_vgg to "
    "lpips.LPIPS(net='vgg') on shared inputs")


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--batch-size", type=int, default=1,
                   help="test images per sampler call (requires -n 1 when "
                        "> 1); the reference asserts batch_size == 1")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel sampling over the ranks of a "
                        "process group, one card each (launch with "
                        "torchrun; --batch-size must divide by the world "
                        "size)")
    p.add_argument("--checkpoint", type=str,
                   default="../model_zoo/diffusion_ffhq_10m.pt")
    p.add_argument("--config", type=str, default="configs/test_ffhq.json")
    p.add_argument("--operator-config", type=str,
                   default="configs/inpainting_config.yaml")
    p.add_argument("-n", type=int, default=1,
                   help="number of samples per test image")
    p.add_argument("--prefix", type=str, default="out")
    p.add_argument("--logdir", type=str,
                   default=os.path.join("runs", "sample_condition", "temp"))
    p.add_argument("--save-img", dest="save_img", action="store_true")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="skip images already recorded in "
                        "<logdir>/metrics.jsonl (per-batch generators are "
                        "seeded by index, so resumed runs produce the exact "
                        "samples an uninterrupted run would)")
    # sampler
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--ode", dest="ode", action="store_true")
    p.add_argument("--euler", dest="euler", action="store_true")
    p.add_argument("--sampler", choices=["heun", "euler", "dpmpp_2m"],
                   default=None,
                   help="overrides --euler: sampler for the guided chain")
    # guidance
    p.add_argument("--guidance", type=str, default="I")
    p.add_argument("--xstart-cov-type", type=str, default="convert",
                   choices=["analytic", "convert", "pgdm", "dps", "diffpir",
                            "tmpd"])
    p.add_argument("--mle-sigma-thres", type=float, default=None,
                   help="default 0.2 (v1, ref: sample_condition_openai.py"
                        ":97) or 1.0 with --v2 (ref: sample_condition_"
                        "openai_v2.py:90)")
    p.add_argument("--lam", type=float, default=None)
    p.add_argument("--zeta", type=float, default=None)
    p.add_argument("--num-hutchinson-samples", type=int, default=None)
    p.add_argument("--eta", type=float, default=None)
    # None: the reference's 1000-iteration budget (converging solves exit
    # early)
    p.add_argument("--cg-maxiter", type=int, default=None)
    # warm-start each CG solve from the previous sampler step's iterate
    # (GuidanceConfig.cg_warm_start); guidance I/II, heun or euler
    p.add_argument("--cg-warm-start", action="store_true")
    # v2 (learned covariance; ref: sample_condition_openai_v2.py)
    p.add_argument("--v2", action="store_true",
                   help="DWT/DCT learned-covariance checkpoint path")
    p.add_argument("--spatial-var", action="store_true",
                   help="v2: use the spatial variance head (disables the "
                        "ortho transform; ref: sample_condition_openai_v2.py:163)")
    p.add_argument("--lpips-weights", type=str, default=None,
                   help="path to kdip_tpu's LPIPS-VGG weights (.npz)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--winograd", action="store_true",
                   help="route the UNet's ResBlock 3x3 convs through the "
                        "Winograd F(2,3) kernel (csrc/winograd_f23.cu; "
                        "bf16 torsos only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; pass cpu "
                        "to run on the CPU)")
    return p


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA card is visible; pass "
                         "--device cpu to run on the CPU")
    return dev


def _generators(seed: int, start: int, dev: torch.device):
    """The measurement's and the sampler's generators of the batch that
    starts at image `start` (jax's fold_in(key, 2*start) and 2*start+1)."""
    return [seeded_generator(dev, seed, stream)
            for stream in (2 * start, 2 * start + 1)]


def load_lpips_params(path: str, dev: torch.device):
    """`metrics.lpips_vgg`'s tensors on dev from kdip_tpu's LPIPS npz: its
    param tree under "params" (a pickled object, as
    `metrics.convert_lpips_weights`' tree is saved), or convert_weights'
    flat names."""
    with np.load(path, allow_pickle=True) as lp:
        tree = lp["params"].item() if "params" in lp else dict(lp)
    return {k: v.to(dev) for k, v in
            weights.lpips_from_jax_params(tree).items()}


def _recon_mse(path: str):
    """The analytic covariance's table from an .npz or a torch file."""
    keys = ("sigmas", "mse_list")
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: np.asarray(data[k], np.float32) for k in keys}
    data = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(data[k], np.float32) for k in keys}


def _load_model(args, config, dev, group=None):
    """The model from the config and the checkpoint, and the DDPM tables.
    An image_v2 config gives its k-diffusion UNet in float32 (the tables
    unused by its EDM path; `kdip_tpu` cli/sample_condition.py:139-147,
    179-188); otherwise the ADM UNet (with the variance head under --v2),
    pre-cast under --dtype bfloat16. Under a process group rank 0 reads
    the checkpoint and broadcasts it."""
    sd = (ckpt.load_torch_checkpoint(args.checkpoint) if group is None
          else pdist.load_state_dict(args.checkpoint, group=group))
    if config["model"]["type"] == "image_v2":
        model = ckpt.load_strict(kconfig.make_model(config, device=dev), sd)
        tables = diffusion.make_diffusion(1000, "linear", device=dev)
        return model.eval().requires_grad_(False), tables
    model, tables = kconfig.make_openai_model(config["model"],
                                              winograd=args.winograd,
                                              device=dev)
    if args.v2:
        model = ckpt.load_v2(adm.ADMUNetV2(model), sd)
    else:
        model = ckpt.load_strict(model, sd)
    if args.dtype == "bfloat16":
        # one cast of the torso; the GroupNorm parameters stay float32
        weights.precast_inference(model)
    return model.eval().requires_grad_(False), tables


def dp_group(args, dev: torch.device):
    """(the process group, this rank's device) under --dp, after joining
    the launcher's group; (None, dev) without --dp. --dp without a process
    group to join exits with a message."""
    if not args.dp:
        return None, dev
    if not pdist.setup_dist(device=dev.type):
        raise SystemExit("--dp needs a process group: launch with torchrun "
                         "--nproc_per_node=N (or set RANK, WORLD_SIZE, "
                         "MASTER_ADDR and MASTER_PORT)")
    return (torch.distributed.group.WORLD,
            pdist.dev() if dev.type == "cuda" else dev)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = _device(args.device)

    config = kconfig.load_config(args.config)
    model_config = config["model"]
    dataset_config = config["dataset"]
    native_v2 = model_config["type"] == "image_v2"
    group, dev = dp_group(args, dev)
    world = pdist.get_world_size(group) if group else 1
    lead = group is None or pdist.get_rank(group) == 0
    if args.batch_size % world:
        raise SystemExit(f"--dp needs --batch-size divisible by the world "
                         f"size ({world})")
    if args.batch_size > 1 and args.n != 1:
        raise SystemExit("--batch-size > 1 requires -n 1 (one sample per "
                         "image; samples are paired with measurements "
                         "element-wise along the batch axis)")
    size = model_config["input_size"]
    if len(size) != 2 or size[0] != size[1]:
        raise SystemExit(f"input_size {size}: square images only")
    ortho_tf_type = (model_config.get("ortho_tf_type")
                     if args.v2 or native_v2 else None)
    if args.spatial_var:
        ortho_tf_type = None

    model, tables = _load_model(args, config, dev, group)
    recon_mse = None
    if args.xstart_cov_type == "analytic":
        recon_mse = _recon_mse(model_config.get("recon_mse"))

    operator_config = kconfig.load_yaml(args.operator_config)
    operator = operators.get_operator(seed=args.seed, device=dev,
                                      **operator_config)
    print(f"Operation: {operator_config['name']} / sigma_s: "
          f"{operator_config['sigma_s']}", flush=True)

    mle_thres = args.mle_sigma_thres
    if mle_thres is None:
        mle_thres = 1.0 if args.v2 or native_v2 else 0.2
    gcfg = guidance.GuidanceConfig(
        guidance=args.guidance, x0_cov_type=args.xstart_cov_type,
        mle_sigma_thres=mle_thres, zeta=args.zeta, lambda_=args.lam,
        eta=args.eta, num_hutchinson_samples=args.num_hutchinson_samples,
        ortho_tf_type=ortho_tf_type, cg_maxiter=args.cg_maxiter,
        cg_warm_start=args.cg_warm_start)
    scfg = sampling_api.SamplerConfig(
        steps=args.steps, sigma_min=model_config["sigma_min"],
        sigma_max=model_config["sigma_max"],
        sampler=args.sampler or ("euler" if args.euler else "heun"),
        ode=args.ode)
    if group is not None:
        # the batched sampler over each rank's block (`kdip_tpu` :253-259)
        scfg = dataclasses.replace(scfg, per_sample_map=False)
    uncond_pair = None
    if native_v2:
        # 9 zeros of augmentation conditioning under augment_wrapper
        # (`kdip_tpu` cli/sample_condition.py:190-198)
        n_mapping = 9 if model_config.get("augment_wrapper") else 0

        def model_apply(x_scaled, sigma_b):
            cond = (x_scaled.new_zeros(x_scaled.shape[0], n_mapping)
                    if n_mapping else None)
            return model(x_scaled, sigma_b, mapping_cond=cond,
                         return_variance=True)
        uncond_pair = guidance.make_kdiff_v2_uncond(
            model_apply, gcfg, sigma_data=model_config.get("sigma_data", 0.5))
    sampler = sampling_api.build_posterior_sampler(
        model, tables, operator, gcfg, scfg, recon_mse=recon_mse,
        v2=args.v2 or native_v2, image_size=size[0],
        channels=model_config.get("input_channels", 3), device=dev,
        uncond_pair=uncond_pair)
    if group is not None:
        sampler = _gathered(sharding.make_sharded_sampler(sampler, group),
                            group)

    lpips_params = None
    if args.lpips_weights:
        lpips_params = load_lpips_params(args.lpips_weights, dev)

    if lead:
        os.makedirs(args.logdir, exist_ok=True)
        kconfig.save_yaml(vars(args), os.path.join(args.logdir, "args.yaml"))

    test_set = FolderOfImages(dataset_config["location"])
    metrics_list = []
    done = {}
    journal_path = os.path.join(args.logdir, "metrics.jsonl")
    # sampling-relevant settings; a resume against a journal written with
    # different settings would silently report the old run's numbers. The
    # device is one: the CPU's and the card's generators draw differently
    run_cfg = {"steps": args.steps, "sampler": args.sampler,
               "euler": args.euler, "ode": args.ode,
               "guidance": args.guidance, "cov": args.xstart_cov_type,
               "mle_sigma_thres": mle_thres, "zeta": args.zeta,
               "lam": args.lam, "eta": args.eta,
               "cg_maxiter": args.cg_maxiter, "seed": args.seed,
               "n": args.n, "v2": args.v2, "operator": args.operator_config,
               # generators are seeded by batch-start index, so a resumed
               # run with another batch layout would draw other samples
               "batch_size": args.batch_size, "dp": args.dp,
               "device": dev.type}
    lines = None
    if lead and args.resume and os.path.exists(journal_path):
        with open(journal_path) as f:
            lines = f.read().splitlines()
    if group is not None:
        lines = pdist.broadcast_object(lines, group)
    if lines is not None:
        header = json.loads(lines[0]) if lines else {}
        if header.get("run_cfg") != run_cfg:
            raise SystemExit(
                f"--resume refused: {journal_path} was written with "
                f"different settings ({header.get('run_cfg')} vs {run_cfg}); "
                "use a fresh --logdir or delete the journal")
        for line in lines[1:]:
            rec = json.loads(line)
            done[rec.pop("image")] = rec
        metrics_list.extend(done.values())
        print(f"resume: {len(done)} images already done", flush=True)
    elif lead:
        with open(journal_path, "w") as f:  # fresh run: truncate the journal
            f.write(json.dumps({"run_cfg": run_cfg}) + "\n")
    n_images = len(test_set) if args.max_images is None \
        else min(args.max_images, len(test_set))

    t_start = time.time()
    run_stats = {}
    try:
        _run_images(args, dev, n_images, test_set, operator, sampler,
                    metrics_list, lpips_params, done, journal_path,
                    run_stats, lead)
    except KeyboardInterrupt:
        # graceful interrupt (ref: sample_condition_openai.py:214-217):
        # report and save the averages over the images completed so far
        print(f"interrupted after {len(metrics_list)} images", flush=True)
    avg = (_summarize(args, gcfg, metrics_list, run_stats, t_start)
           if lead else None)
    return avg if group is None else pdist.broadcast_object(avg, group)


def _gathered(sharded, group):
    """The sharded sampler with every rank's block gathered: each rank
    holds the whole batch's samples, as the one-process sampler returns
    them."""
    def sample(measurement, n=1, generator=None, return_info=False):
        out = sharded(measurement, n, generator=generator,
                      return_info=return_info)
        local = out[0] if return_info else out
        whole = torch.cat(sharding.all_gather_blocks(local, group))
        return (whole, out[1]) if return_info else whole
    return sample


def _summarize(args, gcfg, metrics_list, run_stats, t_start):
    """The run's averages, printed and written to avg_metrics.yaml ({}
    when no image was done)."""
    if not metrics_list:
        return {}
    avg = metrics.calculate_average_metric(metrics_list)
    if "cg_max_residual" in run_stats:
        avg["cg_max_residual"] = run_stats["cg_max_residual"]
        budget = guidance.resolved_cg_maxiter(gcfg)
        status = ("converged" if run_stats["cg_max_residual"] <= gcfg.cg_tol
                  else "TRUNCATED — raise --cg-maxiter")
        print(f"CG solves: worst relative residual "
              f"{run_stats['cg_max_residual']:.3e} over the run "
              f"(tol {gcfg.cg_tol:g}, budget {budget} iters): {status}",
              flush=True)
        if args.cg_warm_start:
            avg["cg_total_iters"] = run_stats["cg_total_iters"]
            print(f"CG warm-start: {run_stats['cg_total_iters']} total "
                  f"iterations across the run", flush=True)
    avg["wall_clock_per_image"] = (time.time() - t_start) / max(
        1, len(metrics_list))
    if "lpips" in avg:
        avg["lpips_note"] = LPIPS_NOTE
    print(avg, flush=True)
    kconfig.save_yaml(avg, os.path.join(args.logdir, "avg_metrics.yaml"))
    return avg


def _run_images(args, dev, n_images, test_set, operator, sampler,
                metrics_list, lpips_params, done, journal_path, run_stats,
                lead=True):
    """Samples the images batch by batch; the lead rank (the only one
    without --dp) scores them and writes the journal and PNGs."""
    batch = args.batch_size
    n_per_call = batch if batch > 1 else args.n
    with (open(journal_path, "a") if lead
          else contextlib.nullcontext()) as journal:
        for start in range(0, n_images, batch):
            idxs = list(range(start, min(start + batch, n_images)))
            if all(i in done for i in idxs):
                continue
            x0 = torch.from_numpy(np.stack(
                [test_set[i][0] for i in idxs])).to(dev)
            if len(idxs) < batch:  # pad the final partial batch
                x0 = torch.cat([x0, x0[-1:].expand(
                    batch - len(idxs), *x0.shape[1:])])
            g_meas, g_samp = _generators(args.seed, start, dev)
            measurement = operator.measure(x0, generator=g_meas)
            hat_x0, info = sampler(measurement, n=n_per_call,
                                   generator=g_samp, return_info=True)
            run_stats["cg_max_residual"] = max(
                run_stats.get("cg_max_residual", 0.0),
                float(info["cg_max_residual"]))
            run_stats["cg_total_iters"] = (run_stats.get("cg_total_iters", 0)
                                           + int(info["cg_total_iters"]))
            if not lead:
                continue
            for bi, i in enumerate(idxs):
                if i in done:
                    continue
                # one sample per image with a batch; sample 0 with -n
                m = metrics.compute_metrics(hat_x0[bi:bi + 1],
                                            x0[bi:bi + 1], lpips_params)
                metrics_list.append(m)  # before the print: an interrupt
                print(m, flush=True)    # must never lose a computed image
                journal.write(json.dumps(dict(m, image=i)) + "\n")
                journal.flush()

                if args.save_img:
                    write_png(os.path.join(
                        args.logdir, f"{args.prefix}_img_{i}_measurement.png"),
                        to_uint8_image(measurement.y[bi]))
                    samples = hat_x0[bi:bi + 1] if batch > 1 else hat_x0
                    for j in range(samples.shape[0]):
                        write_png(os.path.join(
                            args.logdir,
                            f"{args.prefix}_img_{i}_hat_x0_sample_{j}.png"),
                            to_uint8_image(samples[j]))


if __name__ == "__main__":
    main()
