"""Parameter trees between `kdip_tpu`'s flax layout and the port's state
dicts, and the bfloat16 inference pre-cast.

`from_jax_params` is the inverse of `kdip_tpu.ckpt.convert_adm_state_dict`
(ckpt.py:42-129) plus the V2 `out_cov` head (ckpt.py:281-286): it takes a
nested dict of numpy arrays in the flax ADMUNet layout and returns a
guided-diffusion state dict (NCHW/OIHW), which loads into
`models.adm.ADMUNet`, or, for a {"unet", "out_cov"} tree, into
`models.adm.ADMUNetV2`. `classifier_from_jax_params` and
`kdiff_from_jax_params` invert `kdip_tpu.ckpt.convert_classifier_state_dict`
(ckpt.py:132-192) and `convert_kdiff_state_dict` (ckpt.py:194-278): a
guided-diffusion classifier's and a k-diffusion UNet's state dicts.
`lpips_from_jax_params` turns `kdip_tpu`'s LPIPS-VGG
weights (the npz that its `--lpips-weights` reads) into
`metrics.lpips_vgg`'s tensors, and `inception_from_jax_params` the flax
InceptionV3 variables into `models.inception`'s state dict. This module
needs no JAX: it reads numpy arrays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from .models.kdiff import fir_kernel_2d
from .models.layers import GroupNorm32

# flax sub-path inside a block -> guided-diffusion sub-module
# (inverse of kdip_tpu/ckpt.py:42-54)
_BLOCK_LEAVES = {
    ("in_norm", "GroupNorm_0"): "in_layers.0",
    ("in_conv",): "in_layers.2",
    ("emb_proj",): "emb_layers.1",
    ("out_norm", "GroupNorm_0"): "out_layers.0",
    ("out_conv",): "out_layers.3",
    ("skip",): "skip_connection",
    ("norm", "GroupNorm_0"): "norm",
    ("qkv",): "qkv",
    ("proj_out",): "proj_out",
    ("op",): "op",
    ("conv",): "conv",
}
# flax Dense layers that are 1x1 Conv1d in guided-diffusion
_CONV1D = ("qkv", "proj_out")
_BLOCK_RE = re.compile(r"^(input_blocks|output_blocks)_(\d+)_(\d+)$|"
                       r"^(middle_block)_(\d+)$")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _leaf(pname: str, w: np.ndarray, conv1d: bool) -> tuple:
    """flax param (name, array) -> (torch param name, array)."""
    if pname == "bias":
        return "bias", w
    if pname == "scale":
        return "weight", w
    if pname != "kernel":
        raise KeyError(f"unmapped flax param {pname!r}")
    if w.ndim == 4:  # conv HWIO -> OIHW
        return "weight", w.transpose(3, 2, 0, 1)
    if conv1d:  # Dense I O -> Conv1d O I 1
        return "weight", w.T[..., None]
    return "weight", w.T  # Dense I O -> Linear O I


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _unet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, w in _flatten(params):
        top, pname = path[0], path[-1]
        if top == "label_emb":
            sd["label_emb.weight"] = _tensor(w)
            continue
        if top in ("time_embed_1", "time_embed_2"):
            mod = {"time_embed_1": "time_embed.0",
                   "time_embed_2": "time_embed.2"}[top]
            conv1d = False
        elif top in ("out_norm", "out_conv"):
            mod = {"out_norm": "out.0", "out_conv": "out.2"}[top]
            conv1d = False
        else:
            m = _BLOCK_RE.match(top)
            if m is None:
                raise KeyError(f"unmapped flax module {top!r}")
            if m.group(1):
                block = f"{m.group(1)}.{m.group(2)}.{m.group(3)}"
            else:
                block = f"middle_block.{m.group(5)}"
            rest = tuple(path[1:-1])
            if rest == ():  # input_blocks_0_0: the stem conv
                mod, conv1d = block, False
            else:
                if rest not in _BLOCK_LEAVES:
                    raise KeyError(f"unmapped flax path {'/'.join(path)}")
                mod, conv1d = f"{block}.{_BLOCK_LEAVES[rest]}", rest[0] in _CONV1D
        name, val = _leaf(pname, w, conv1d)
        sd[f"{mod}.{name}"] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ADMUNet params (nested dict of arrays) -> ADMUNet state dict; a
    {"unet": ..., "out_cov": ...} tree -> ADMUNetV2 state dict. float32."""
    if "unet" not in params:
        return _unet_state_dict(params)
    sd = {f"inner_model.{k}": v
          for k, v in _unet_state_dict(params["unet"]).items()}
    cov = params["out_cov"]
    sd["out_cov.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(cov["kernel"], np.float32).transpose(3, 2, 0, 1)))
    sd["out_cov.bias"] = torch.from_numpy(np.asarray(cov["bias"], np.float32))
    return sd


# the classifier head's flax modules -> its `out` Sequential indices, by
# pool (inverse of kdip_tpu/ckpt.py:139-146)
_CLASSIFIER_OUT = {
    "adaptive": {"out_norm": "0", "out_proj": "3"},
    "attention": {"out_norm": "0", "out_pool": "2"},
    "spatial": {"out_fc1": "0", "out_fc2": "2"},
    "spatial_v2": {"out_fc1": "0", "out_norm": "1", "out_fc2": "3"},
}


def classifier_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax EncoderADMUNet params -> a guided-diffusion EncoderUNetModel
    state dict (`models.adm.EncoderADMUNet`), float32; the pool is read
    from the head's modules. AttentionPool2d's positional embedding goes
    back to the reference's [C, T+1]."""
    if "out_pool" in params:
        pool = "attention"
    elif "out_proj" in params:
        pool = "adaptive"
    else:
        pool = "spatial_v2" if "out_norm" in params else "spatial"
    head = _CLASSIFIER_OUT[pool]
    sd = _unet_state_dict({k: v for k, v in params.items()
                           if k not in head})
    for mod, idx in head.items():
        for path, w in _flatten(params[mod]):
            if path[0] == "positional_embedding":
                sd[f"out.{idx}.positional_embedding"] = _tensor(w.T)
                continue
            sub = f".{path[0]}" if mod == "out_pool" else ""
            name, val = _leaf(path[-1], w, conv1d=mod == "out_pool")
            sd[f"out.{idx}{sub}.{name}"] = _tensor(val)
    return sd


# a ResConvBlock's / SelfAttention2d's flax sub-path -> its k-diffusion
# name (inverse of kdip_tpu/ckpt.py:209-233)
_KDIFF_LEAVES = {
    ("norm_1", "mapper"): "main.0.mapper", ("conv_1",): "main.2",
    ("norm_2", "mapper"): "main.4.mapper", ("conv_2",): "main.6",
    ("skip",): "skip", ("norm_in", "mapper"): "norm_in.mapper",
    ("qkv_proj",): "qkv_proj", ("out_proj",): "out_proj",
}
_KDIFF_TOP = {"mapping_0": "mapping.0", "mapping_1": "mapping.2",
              "mapping_cond": "mapping_cond", "proj_in": "proj_in",
              "proj_out": "proj_out"}


def kdiff_from_jax_params(params: Mapping, num_levels: int,
                          skip_stages: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
    """flax ImageDenoiserModelV1/V2 params -> a k-diffusion state dict
    (`models.kdiff`), float32, with the FIR `kernel` buffers of every
    resampling block. num_levels is len(depths); skip_stages defaults to
    the lowest level with a down block, right for a tree of flax's init,
    which has no blocks below skip_stages (a strict load of its state dict
    then needs those from elsewhere). A tree converted from a k-diffusion
    state dict holds every level: pass skip_stages then."""
    blocks = {k for k in params if k.startswith(("d_block_", "u_block_"))}
    if skip_stages is None:
        skip_stages = min(int(k.rsplit("_", 1)[1]) for k in blocks
                          if k.startswith("d_block_"))
    sd = {}
    for path, w in _flatten(params):
        top, pname = path[0], path[-1]
        if top == "timestep_embed":
            sd["timestep_embed.weight"] = _tensor(w)
            continue
        if top in _KDIFF_TOP:
            name, val = _leaf(pname, w, conv1d=False)
            sd[f"{_KDIFF_TOP[top]}.{name}"] = _tensor(val)
            continue
        if top not in blocks:
            raise KeyError(f"unmapped flax module {top!r}")
        side, level = top.rsplit("_", 1)
        level = int(level)
        block = params[top]
        per_layer = 2 if "attn_0" in block else 1
        first = 1 if side == "d_block" and level > skip_stages else 0
        kind, k = path[1].split("_")
        j = first + int(k) * per_layer + (kind == "attn")
        idx = level if side == "d_block" else num_levels - 1 - level
        leaf = _KDIFF_LEAVES[tuple(path[2:-1])]
        name, val = _leaf(pname, w, conv1d=False)
        sd[f"u_net.{side}s.{idx}.{j}.{leaf}.{name}"] = _tensor(val)
    for top in sorted(blocks):
        side, level = top.rsplit("_", 1)
        level = int(level)
        if level <= skip_stages:
            continue
        if side == "d_block":
            sd[f"u_net.d_blocks.{level}.0.kernel"] = fir_kernel_2d()
        else:
            n = sum(k.startswith(("res_", "attn_")) for k in params[top])
            sd[f"u_net.u_blocks.{num_levels - 1 - level}.{n}.kernel"] = \
                fir_kernel_2d(scale=2.0)
    return sd


def lpips_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """`kdip_tpu`'s LPIPS-VGG params -> `metrics.lpips_vgg`'s float32
    tensors: `conv{i}.kernel` HWIO -> `conv{i}.weight` OIHW, `conv{i}.bias`
    and `lin{i}.kernel` ([C]) as they are. Takes the nested tree
    ({"conv0": {"kernel", "bias"}, ...}) or the flat names of
    `kdip_tpu.cli.convert_weights lpips` ({"conv0.kernel": ...})."""
    flat = {".".join(path): w for path, w in _flatten(params)}
    sd = {}
    for name, w in flat.items():
        mod, _, pname = name.rpartition(".")
        if pname == "kernel" and mod.startswith("conv"):
            sd[f"{mod}.weight"] = w.transpose(3, 2, 0, 1)
        elif pname == "kernel" and mod.startswith("lin"):
            sd[f"{mod}.weight"] = w
        elif pname == "bias" and mod.startswith("conv"):
            sd[name] = w
        else:
            raise KeyError(f"unmapped LPIPS param {name!r}")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sorted(sd.items())}


def inception_from_jax_params(variables: Mapping) -> Dict[str, torch.Tensor]:
    """`kdip_tpu`'s InceptionV3 variables ({"params", "batch_stats"}) ->
    `models.inception.InceptionV3Features`' state dict, the inverse of
    `kdip_tpu.models.inception.convert_inception_state_dict`
    (inception.py:178-224): `conv.kernel` HWIO -> `conv.weight` OIHW,
    `bn.scale` / `bn.bias` -> `bn.weight` / `bn.bias`, `bn.mean` /
    `bn.var` -> `bn.running_mean` / `bn.running_var`. BatchNorm's
    `num_batches_tracked`, which no forward reads, is left out: a strict
    load of a plain dict fills it in."""
    names = {("params", "conv", "kernel"): "conv.weight",
             ("params", "bn", "scale"): "bn.weight",
             ("params", "bn", "bias"): "bn.bias",
             ("batch_stats", "bn", "mean"): "bn.running_mean",
             ("batch_stats", "bn", "var"): "bn.running_var"}
    sd = {}
    for col in ("params", "batch_stats"):
        for path, w in _flatten(variables[col]):
            leaf = names.get((col,) + path[-2:])
            if leaf is None:
                raise KeyError(f"unmapped Inception {col} leaf "
                               f"{'/'.join(path)!r}")
            if leaf == "conv.weight":
                w = w.transpose(3, 2, 0, 1)
            sd[".".join(path[:-2] + (leaf,))] = torch.from_numpy(
                np.ascontiguousarray(w))
    return dict(sorted(sd.items()))


def randomize_(model: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Draws every parameter from a seeded numpy generator, in place,
    zero-initialised layers included (out.2, the ResBlocks' out_layers.3,
    proj_out), or eps is identically 0 and a run proves nothing: GroupNorm
    weights 1 + std*N(0,1), everything else std*N(0,1). Returns the model."""
    norm_weights = {f"{n}.weight" for n, m in model.named_modules()
                    if isinstance(m, GroupNorm32)}
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            v = std * rng.standard_normal(p.shape, dtype=np.float32)
            if name in norm_weights:
                v += 1.0
            p.copy_(torch.from_numpy(v))
    return model


def precast_inference(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Casts every parameter to `dtype` except GroupNorm32's, in place, for
    inference with a low-precision torso (`kdip_tpu.utils.
    precast_inference_params`): the norm parameters feed float32 statistics
    and stay float32. Returns the model."""
    for module in model.modules():
        if isinstance(module, GroupNorm32):
            continue
        for name, p in module.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
    return model
