"""The inpainting mix's operator (configs/inpainting_config.yaml of the
source repository): a random mask that zeroes floor(H W p) pixels, the same
pixels in every channel, drawn once a run from the seed; y = mask * (x +
sigma_s n) for each solve. `program` hands the mask to the program's
operator, `reference` to the reference's."""

import numpy as np
import torch

from harness import inputs


def draw(opcfg: dict, seed: int, shape, device) -> dict:
    _, C, H, W = shape
    mo = opcfg["mask_opt"]
    if mo["mask_type"] != "random":
        raise ValueError("the inpainting mix draws random masks")
    lo, hi = mo["mask_prob_range"]
    g = inputs.generator("cpu", seed, "mask")
    p = lo + (hi - lo) * float(torch.rand((), generator=g))
    drop = torch.randperm(H * W, generator=g)[:int(H * W * p)]
    mask = torch.ones(H * W)
    mask[drop] = 0
    mask = mask.reshape(1, 1, H, W).expand(1, C, H, W).contiguous()
    return {"mask": mask.to(device)}


def measure(opcfg: dict, drawn: dict, x, n):
    sigma_s = float(np.float32(opcfg["sigma_s"]))
    return (x + sigma_s * n) * drawn["mask"]


def program(opcfg: dict, drawn: dict, device):
    from kdip_tpu_torch import operators
    mask = drawn["mask"][0].permute(1, 2, 0).cpu().numpy()
    return operators.get_operator(name="inpainting",
                                  sigma_s=opcfg["sigma_s"], mask=mask,
                                  device=device)


def reference(opcfg: dict, drawn: dict, y):
    from reference.op_inpainting import Inpainting
    return Inpainting(y, drawn["mask"], opcfg["sigma_s"])
