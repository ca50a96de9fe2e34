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
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch

from .. import ckpt, evaluation, metrics
from ..data import FolderOfImages
from ..models.inception import make_inception_extractor
from ..ops.resize import jax_resize
from .sample_condition import _device, load_lpips_params

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
                   help="data-parallel feature extraction over several "
                        "cards: not ported yet (refused)")
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


def folder_features(path: str, extractor, args, dev) -> torch.Tensor:
    """The features of the first --max-images images of the folder (all of
    them by default), in `FolderOfImages`' order, on dev."""
    ds = FolderOfImages(path, size=args.size)
    n = len(ds) if args.max_images is None else min(args.max_images, len(ds))
    feats, seen = [], 0
    with contextlib.closing(ds.batches(args.batch_size,
                                       num_workers=DECODE_WORKERS)) as it:
        for batch in it:
            feats.append(extractor(torch.from_numpy(batch).to(dev)))
            seen += batch.shape[0]
            if seen >= n:
                break
    return torch.cat(feats)[:n]


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = _device(args.device)
    if args.dp:
        raise SystemExit("--dp (data-parallel feature extraction over "
                         "several cards) is not ported yet: ROADMAP queue "
                         "1, entry 9")
    if args.paired:
        return _report(_paired(args, dev), args.out)

    extractor = _extractor(args, dev)
    f_real = folder_features(args.real, extractor, args, dev)
    f_fake = folder_features(args.fake, extractor, args, dev)
    return _report({
        "fid": float(evaluation.fid(f_real, f_fake)),
        "kid": float(evaluation.kid(f_real, f_fake)),
        "n_real": int(f_real.shape[0]),
        "n_fake": int(f_fake.shape[0]),
        "backbone": args.backbone,
    }, args.out)


if __name__ == "__main__":
    main()
