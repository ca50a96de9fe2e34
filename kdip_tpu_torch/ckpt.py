"""Checkpoint loading and saving (PyTorch port of `kdip_tpu/ckpt.py:289-322`
and of the CLI's prefix handling, `kdip_tpu/cli/sample_condition.py:
160-177`).

The port's modules carry their reference's parameter names, so a
guided-diffusion `.pt` state dict loads into `models.adm.ADMUNet`, a
guided-diffusion classifier's into `models.adm.EncoderADMUNet`, and a
k-diffusion state dict into `models.kdiff`'s ImageDenoiserModelV1/V2,
FIR buffers included, as they are (`load_strict`; `kdip_tpu` strips no
prefix from the last either, cli/sample_condition.py:161-164). A
Lightning DWT/DCT-Var checkpoint nests `inner_model.*` and `out_cov.*`
under `model_ema.` or `model.`; the port's fine-tune writes them bare
(`load_v2` reads all three). All load strictly, so a misnamed key fails
loudly. A directory checkpoint is `kdip_tpu`'s orbax format, which needs
JAX: the port refuses it, and saves torch files instead
(`save_checkpoint`, written under a temporary name and renamed, as an
orbax save is atomic).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

from .models.adm import ADMUNetV2


def refuse_orbax(path: str) -> None:
    if os.path.isdir(path):
        raise SystemExit(
            f"{path} is a directory: an orbax checkpoint of kdip_tpu, which "
            "only JAX reads. Give the port a torch .pt/.ckpt file (the "
            "PyTorch port has no orbax reader)")


def load_torch_checkpoint(path) -> Dict[str, Any]:
    """A .pt/.ckpt file (a path, or a file object holding its bytes),
    loaded on the CPU, as a flat state dict; a
    Lightning checkpoint's {"state_dict": ...} is unwrapped (ref:
    train_openai.py:56-88). As in kdip_tpu, the whole pickle is read
    (weights_only=False): a Lightning file's hyper_parameters, callbacks
    and loops may hold objects beyond tensors and plain containers. So a
    checkpoint is trusted as code is."""
    if isinstance(path, str):
        refuse_orbax(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        return obj["state_dict"]
    return obj


def strip_prefix(state_dict: Mapping[str, Any], prefix: str
                 ) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def load_strict(model: torch.nn.Module,
                sd: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """Loads a state dict named as the model's reference names it,
    strictly. Returns model."""
    model.load_state_dict(sd, strict=True)
    return model


def load_v2(model: ADMUNetV2, sd: Mapping[str, torch.Tensor]) -> ADMUNetV2:
    """Loads a DWT/DCT-Var state dict: a Lightning checkpoint's EMA
    weights under `model_ema.` if there are any, else `model.`, else the
    bare names that `save_checkpoint` of the port's fine-tune writes;
    `inner_model.*` into the UNet and `out_cov.*` into the variance head,
    each strictly (the wrapper's other entries, such as its sigma tables,
    are not weights). Returns model."""
    for prefix in ("model_ema.", "model.", ""):
        if any(k.startswith(prefix) for k in sd):
            break
    sd_model = strip_prefix(sd, prefix)
    model.inner_model.load_state_dict(strip_prefix(sd_model, "inner_model."),
                                      strict=True)
    model.out_cov.load_state_dict(strip_prefix(sd_model, "out_cov."),
                                  strict=True)
    return model


def save_checkpoint(path: str, obj: Any) -> None:
    """torch.save(obj) to `path`, through a temporary file in the same
    directory that is renamed over it: a reader never sees half a file."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_checkpoint(path) -> Any:
    """A file that save_checkpoint wrote (a path, or a file object holding
    its bytes), tensors on the CPU. It holds tensors and plain containers
    only (weights_only). An orbax directory is refused."""
    if isinstance(path, str):
        refuse_orbax(path)
    return torch.load(path, map_location="cpu", weights_only=True)
