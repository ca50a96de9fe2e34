#!/usr/bin/env python
"""Distribution-metric evaluation CLI: FID / KID between two image folders
(PyTorch port of `kdip_tpu/cli/evaluate.py`).

    python -m kdip_tpu_torch.cli.evaluate real/ fake/ --backbone inception \
        --weights pt_inception-2015-12-05-6726825d.pth [--device cpu]

Feature backbones:
  inception  the FID InceptionV3 (`models.inception`), weights from a
             pt_inception / torchvision `.pth` state dict
  clip       transformers' torch CLIP vision tower (a local checkpoint
             directory; needs the transformers package)
  pixels     raw pixels resized to 32 x 32 (a backbone-free smoke metric)
`--paired` reports the mean per-image PSNR / SSIM (/ LPIPS) between the
two folders instead. The flags, defaults and JSON keys are `kdip_tpu`'s,
with one more: `--device` (default `cuda`; the CPU only when asked for).
Images are decoded by a pool of threads, in `kdip_tpu`'s order.

`--dp` extracts the features data-parallel over the ranks of a process
group, one card each (`torchrun --nproc_per_node=N -m
kdip_tpu_torch.cli.evaluate real/ fake/ --dp ...`): each batch is padded
with zero images to a multiple of N, each rank decodes its block and runs
it through the backbone, and the blocks are gathered in rank order
(`kdip_tpu`'s cli/evaluate.py:91-118). Every rank computes FID and KID;
rank 0 prints them and writes --out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import ckpt, evaluation, metrics
from ..data import FolderOfImages
from ..models.inception import make_inception_extractor
from ..ops.resize import jax_resize
from ..parallel import dist as pdist
from ..parallel import sharding
from .sample_condition import _device, dp_group, load_lpips_params

DECODE_WORKERS = min(8, os.cpu_count() or 1)
PIXELS_SIZE = 32


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("real", help="folder of reference images")
    p.add_argument("fake", help="folder of generated images")
    p.add_argument("--backbone", default="pixels",
                   choices=["inception", "clip", "pixels"])
    p.add_argument("--weights", default=None,
                   help="backbone weights: a pt_inception .pth/.pt state "
                        "dict (inception) or a local transformers CLIP "
                        "directory (clip)")
    p.add_argument("--size", type=int, default=64,
                   help="image size for loading")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--paired", action="store_true",
                   help="paired per-image PSNR/SSIM between the two folders "
                        "(the reference's dps_utils/compute_metric.py) "
                        "instead of distribution metrics")
    p.add_argument("--lpips-weights", default=None,
                   help="kdip_tpu's LPIPS-VGG .npz for paired mode")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel feature extraction over the ranks of "
                        "a process group, one card each (launch with "
                        "torchrun)")
    p.add_argument("--out", default=None, help="optional JSON output path")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; pass cpu "
                        "to run on the CPU)")
    return p


def _report(out: dict, path) -> dict:
    print(json.dumps(out), flush=True)
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def _paired(args, dev) -> dict:
    """Mean per-image metrics of the folders' first n pairs, in index
    order (`kdip_tpu` cli/evaluate.py:53-76)."""
    real = FolderOfImages(args.real, size=args.size)
    fake = FolderOfImages(args.fake, size=args.size)
    n = min(len(real), len(fake))
    if args.max_images:
        n = min(n, args.max_images)
    lpips_params = None
    if args.lpips_weights:
        lpips_params = load_lpips_params(args.lpips_weights, dev)
    results = []
    for i in range(n):
        a = torch.from_numpy(real[i][0])[None].to(dev)
        b = torch.from_numpy(fake[i][0])[None].to(dev)
        results.append(metrics.compute_metrics(b, a, lpips_params))
    out = metrics.calculate_average_metric(results)
    out["n"] = n
    return out


def _extractor(args, dev):
    if args.backbone == "inception":
        if args.weights is None:
            raise SystemExit("--backbone inception needs --weights: a "
                             "pt_inception .pth state dict")
        return make_inception_extractor(ckpt.load_checkpoint(args.weights),
                                        dev)
    if args.backbone == "clip":
        try:
            return evaluation.make_clip_extractor(args.weights, dev)
        except ImportError as e:
            raise SystemExit(f"--backbone clip: {e}") from None

    def pixels(batch):
        # flattened in kdip_tpu's NHWC order, so the features are its own
        x = jax_resize(batch, (PIXELS_SIZE, PIXELS_SIZE), "bilinear")
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return pixels


def _rank_blocks(ds, n: int, batch_size: int, rank: int, world: int):
    """(this rank's block, the batch's size) for each batch of the first n
    images: the batch padded with zero images to a multiple of `world`
    and split in rank order. A pool of DECODE_WORKERS threads decodes the
    block's images alone, two batches ahead of the one yielded (as
    `FolderOfImages.batches` prefetches)."""
    def submit(start):
        size = min(batch_size, n - start)
        k = -(-size // world)
        lo, hi = (start + min(size, i * k) for i in (rank, rank + 1))
        return size, k, [pool.submit(ds.__getitem__, j)
                         for j in range(lo, hi)]

    blank = None

    def collect(size, k, futures):
        nonlocal blank
        imgs = [f.result()[0] for f in futures]
        if blank is None:
            blank = np.zeros_like(imgs[0] if imgs else ds[0][0])
        return np.stack(imgs + [blank] * (k - len(imgs))), size

    with ThreadPoolExecutor(DECODE_WORKERS) as pool:
        pending = deque()
        for start in range(0, n, batch_size):
            pending.append(submit(start))
            if len(pending) > 2:
                yield collect(*pending.popleft())
        while pending:
            yield collect(*pending.popleft())


def folder_features(path: str, extractor, args, dev,
                    group=None) -> torch.Tensor:
    """The features of the first --max-images images of the folder (all of
    them by default), in `FolderOfImages`' order, on dev. Under a process
    group each batch, padded with zero images to a multiple of the world
    size, is split over the ranks: a rank decodes and extracts its block
    alone, and the features are gathered in rank order."""
    ds = FolderOfImages(path, size=args.size)
    n = len(ds) if args.max_images is None else min(args.max_images, len(ds))
    feats = []
    with contextlib.closing(_rank_blocks(
            ds, n, args.batch_size, pdist.get_rank(group),
            pdist.get_world_size(group))) as blocks:
        for x, size in blocks:
            local = extractor(torch.from_numpy(x).to(dev))
            feats.append(torch.cat(sharding.all_gather_blocks(
                local, group))[:size])
    return torch.cat(feats)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = _device(args.device)
    group, dev = dp_group(args, dev)
    # every rank computes the metrics; rank 0 reports them, as kdip_tpu's
    # process 0 does
    report = (_report if group is None or pdist.get_rank(group) == 0
              else lambda out, path: out)
    if args.paired:
        return report(_paired(args, dev), args.out)

    extractor = _extractor(args, dev)
    f_real = folder_features(args.real, extractor, args, dev, group)
    f_fake = folder_features(args.fake, extractor, args, dev, group)
    return report({
        "fid": float(evaluation.fid(f_real, f_fake)),
        "kid": float(evaluation.kid(f_real, f_fake)),
        "n_real": int(f_real.shape[0]),
        "n_fake": int(f_fake.shape[0]),
        "backbone": args.backbone,
    }, args.out)


if __name__ == "__main__":
    main()
