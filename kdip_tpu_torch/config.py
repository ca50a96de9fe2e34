"""JSON experiment configs and the OpenAI model factory (PyTorch port of
`kdip_tpu/config.py:59-113`; ref: k_diffusion/config.py,
guided_diffusion/script_util.py).

`make_openai_model` builds (ADMUNet, DiffusionTables) from a config's
"model" block as the sampling CLI does, `winograd=` included. Only the
OpenAI family and JSON files are ported.
"""

from __future__ import annotations

import json
from typing import IO, Any, Dict, Union

import torch

from . import diffusion
from .models import adm


# OpenAI model flag defaults (ref: diffpir_utils/utils_model.py:353-381)
OPENAI_MODEL_DEFAULTS: Dict[str, Any] = {
    "diffusion_steps": 1000,
    "noise_schedule": "linear",
    "num_head_channels": 64,
    "resblock_updown": True,
    "use_fp16": False,
    "use_scale_shift_norm": True,
    "num_heads": 4,
    "num_heads_upsample": -1,
    "use_new_attention_order": False,
    "timestep_respacing": "",
    "learn_sigma": True,
    "class_cond": False,
    "image_size": 256,
    "num_channels": 128,
    "num_res_blocks": 1,
    "attention_resolutions": "16",
    "dropout": 0.1,
    "channel_mult": "",
}


def load_config(file: Union[str, IO, Dict]) -> Dict:
    """A JSON experiment config from a path, an open file or a dict. Unlike
    `kdip_tpu`'s, it merges no k-diffusion defaults
    (ref: k_diffusion/config.py:12-45): no ported code reads them."""
    if isinstance(file, dict):
        return file
    if isinstance(file, str):
        with open(file) as f:
            return json.load(f)
    return json.load(file)


def make_openai_model(model_config: Dict, dtype=torch.float32,
                      winograd: bool = False, device="cuda"):
    """(ADMUNet, DiffusionTables) from a config's "model" block, its
    "openai" flags over OPENAI_MODEL_DEFAULTS (ref: k_diffusion/config.py:
    52-65 + script_util.create_model_and_diffusion). The model is built in
    `dtype` on `device`; `winograd` takes effect in a bfloat16 or float16
    torso."""
    flags = dict(OPENAI_MODEL_DEFAULTS)
    flags.update(model_config.get("openai", {}))
    if flags["timestep_respacing"]:
        raise NotImplementedError(
            "timestep_respacing is not ported yet: a later slice of the "
            "PyTorch port (ROADMAP queue 1, item 1)")
    model = adm.create_unet(
        image_size=flags["image_size"], num_channels=flags["num_channels"],
        num_res_blocks=flags["num_res_blocks"],
        channel_mult=flags["channel_mult"], learn_sigma=flags["learn_sigma"],
        class_cond=flags["class_cond"],
        attention_resolutions=str(flags["attention_resolutions"]),
        num_heads=flags["num_heads"],
        num_head_channels=flags["num_head_channels"],
        num_heads_upsample=flags["num_heads_upsample"],
        use_scale_shift_norm=flags["use_scale_shift_norm"],
        dropout=flags["dropout"], resblock_updown=flags["resblock_updown"],
        use_new_attention_order=flags["use_new_attention_order"],
        dtype=dtype, device=device, winograd=winograd)
    tables = diffusion.make_diffusion(flags["diffusion_steps"],
                                      flags["noise_schedule"], device=device)
    return model, tables
