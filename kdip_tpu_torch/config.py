"""JSON experiment configs and the model factories (PyTorch port of
`kdip_tpu/config.py`; ref: k_diffusion/config.py,
guided_diffusion/script_util.py).

`load_config` merges a JSON config onto k-diffusion's defaults
(`CONFIG_DEFAULTS`) as `kdip_tpu` does. `make_openai_model` builds
(ADMUNet, DiffusionTables) from a config's "model" block as the sampling
CLI does, `winograd=` included; `make_model` also builds the k-diffusion
native UNets (`models.kdiff`); `make_denoiser_wrapper` names the loss a
config trains with.

`load_yaml` / `save_yaml` read and write the subset of YAML that the
operator configs and the CLI's artefacts use, without PyYAML (which the
card's machine may lack): `key: value` lines, one level of indented
nesting, JSON scalars and inline lists, bare strings and `#` comments
(`save_yaml` writes the CLI's flat maps only). Anything outside it raises
a ValueError that names the line.
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import IO, Any, Dict, Union

import torch

from . import diffusion
from .models import adm, kdiff


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge (replacement for jsonmerge.merge,
    ref: k_diffusion/config.py:47; `kdip_tpu` config.py:23-32)."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


CONFIG_DEFAULTS: Dict[str, Any] = {
    # ref: k_diffusion/config.py:12-45
    "model": {
        "sigma_data": 1.0,
        "patch_size": 1,
        "dropout_rate": 0.0,
        "augment_wrapper": True,
        "augment_prob": 0.0,
        "mapping_cond_dim": 0,
        "unet_cond_dim": 0,
        "cross_cond_dim": 0,
        "cross_attn_depths": None,
        "skip_stages": 0,
        "has_variance": False,
        "loss_config": "karras",
    },
    "dataset": {"type": "imagefolder"},
    "optimizer": {"type": "adamw", "lr": 1e-4, "betas": [0.95, 0.999],
                  "eps": 1e-6, "weight_decay": 1e-3},
    "lr_sched": {"type": "constant"},
    "ema_sched": {"type": "inverse", "power": 0.6667, "max_value": 0.9999},
}


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
    """A JSON experiment config from a path, an open file or a dict,
    merged onto CONFIG_DEFAULTS (ref: k_diffusion/config.py:11-47;
    `kdip_tpu` config.py:72-83): so a "model" block without `sigma_data`
    reads 1.0, `augment_wrapper` True, `mapping_cond_dim` 0."""
    if isinstance(file, dict):
        config = file
    elif isinstance(file, str):
        with open(file) as f:
            config = json.load(f)
    else:
        config = json.load(file)
    return deep_merge(CONFIG_DEFAULTS, config)


def make_openai_model(model_config: Dict, dtype=torch.float32,
                      winograd: bool = False, device="cuda"):
    """(ADMUNet, DiffusionTables) from a config's "model" block, its
    "openai" flags over OPENAI_MODEL_DEFAULTS (ref: k_diffusion/config.py:
    52-65 + script_util.create_model_and_diffusion); the tables are
    respaced by its timestep_respacing. The model is built in
    `dtype` on `device`; `winograd` takes effect in a bfloat16 or float16
    torso."""
    flags = dict(OPENAI_MODEL_DEFAULTS)
    flags.update(model_config.get("openai", {}))
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
                                      flags["noise_schedule"],
                                      flags["timestep_respacing"] or None,
                                      device=device)
    return model, tables


def make_model(config: Dict, dtype=torch.float32, device="cuda",
               winograd: bool = False):
    """Model factory (ref: k_diffusion/config.py:50-90; `kdip_tpu`
    config.py:116-136) on a merged config: an "openai*" type returns
    make_openai_model's (model, tables); "image_v2" and "image_v1" the
    k-diffusion native UNet in float32 on `device` (dtype and winograd
    apply to the OpenAI family only), its mapping conditioning 9 wider
    under augment_wrapper."""
    mc = config["model"]
    ty = mc["type"]
    if ty.startswith("openai"):
        return make_openai_model(mc, dtype=dtype, winograd=winograd,
                                 device=device)
    if ty == "image_v2":
        Model = kdiff.ImageDenoiserModelV2
    elif ty == "image_v1":
        Model = kdiff.ImageDenoiserModelV1
    else:
        raise ValueError("Invalid denoiser type")
    mapping_cond_dim = mc["mapping_cond_dim"] + (
        9 if mc["augment_wrapper"] else 0)
    return Model(
        c_in=mc["input_channels"], feats_in=mc["mapping_out"],
        depths=tuple(mc["depths"]), channels=tuple(mc["channels"]),
        self_attn_depths=tuple(mc["self_attn_depths"]),
        mapping_cond_dim=mapping_cond_dim, unet_cond_dim=mc["unet_cond_dim"],
        dropout_rate=mc["dropout_rate"], patch_size=mc["patch_size"],
        skip_stages=mc["skip_stages"], has_variance=mc["has_variance"],
        device=device)


def make_denoiser_wrapper(config: Dict):
    """Loss/denoiser wrapper factory (ref: k_diffusion/config.py:93-107;
    `kdip_tpu` config.py:139-156): (loss_kind, sigma_data, ortho_tf_type),
    loss_kind "edm", "variance" or "simple"."""
    mc = config["model"]
    sigma_data = mc.get("sigma_data", 1.0)
    has_variance = mc.get("has_variance", False)
    loss_config = mc.get("loss_config", "karras")
    ortho_tf_type = mc.get("ortho_tf_type", None)
    if loss_config == "karras":
        kind = "variance" if has_variance else "edm"
        return kind, sigma_data, ortho_tf_type
    if loss_config == "simple":
        if has_variance:
            raise ValueError("the simple loss cannot train a variance head")
        return "simple", sigma_data, ortho_tf_type
    raise ValueError("Unknown loss config type")


# ---------------------------------------------------------------------------
# The YAML subset
# ---------------------------------------------------------------------------

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_\-]*")
# YAML 1.1 floats need a dot, and a signed exponent (PyYAML's resolver)
_YAML_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOATS = {".nan": math.nan, ".inf": math.inf, "-.inf": -math.inf}


def _split_comment(text: str, where: str) -> str:
    """The value of `text` without its trailing comment: a JSON string or
    list is read to its end first, so a `#` inside it stays."""
    text = text.strip()
    if text[:1] in ('"', "["):
        try:
            _, end = json.JSONDecoder().raw_decode(text)
        except json.JSONDecodeError:
            raise ValueError(f"{where}: not a JSON string or list: "
                             f"{text!r}") from None
        rest = text[end:].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"{where}: text after the value: {rest!r}")
        return text[:end]
    m = re.search(r"(^|\s)#", text)
    return text[:m.start()].strip() if m else text


def _check_numbers(raw: str, where: str) -> None:
    """Each number of a JSON scalar or flat list must be one that YAML 1.1
    reads as the same number."""
    for tok in re.findall(r'"(?:[^"\\]|\\.)*"|[^,\s\[\]]+', raw):
        if tok[0] != '"' and isinstance(json.loads(tok), float) \
                and not _YAML_FLOAT.fullmatch(tok):
            raise ValueError(f"{where}: YAML reads {tok!r} as a string; "
                             f"write it with a dot and a signed exponent")


def _scalar(text: str, where: str):
    """A value of the subset: a JSON scalar or flat list, .nan/.inf, or a
    bare string that YAML 1.1 reads as the same string."""
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    try:
        value = json.loads(text)
    except json.JSONDecodeError:
        value = None
    else:
        items = value if isinstance(value, list) else [value]
        if any(isinstance(i, (dict, list)) for i in items) or \
                isinstance(value, dict):
            raise ValueError(f"{where}: nested lists and maps are outside "
                             f"the subset")
        _check_numbers(text, where)
        return value
    if (text[0] in "-+.0123456789[]{}\"'&*!|>%@`?:,"
            or ": " in text or text.lower() in (
                "y", "n", "yes", "no", "on", "off", "true", "false",
                "null", "~")):
        raise ValueError(f"{where}: bare value {text!r} is outside the "
                         f"subset (quote it as a JSON string)")
    return text


def load_yaml(file_path: str) -> Dict[str, Any]:
    """Reads the YAML subset (see the module docstring) into a dict."""
    out: Dict[str, Any] = {}
    open_key, indent = None, None   # a top-level `key:` and its lines' indent
    with open(file_path) as f:
        lines = f.read().splitlines()
    for n, line in enumerate(lines, 1):
        where = f"{file_path}:{n}"
        if "\t" in line:
            raise ValueError(f"{where}: tabs are outside the subset")
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        lead = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep or not _KEY.fullmatch(key) or rest[:1] not in ("", " "):
            raise ValueError(f"{where}: not a `key: value` line: {line!r}")
        value = _split_comment(rest, where) if rest else ""
        if lead == 0:
            target, open_key, indent = out, None, None
        elif open_key is not None and indent in (None, lead):
            indent = lead
            if out[open_key] is None:
                out[open_key] = {}
            target = out[open_key]
        else:
            raise ValueError(f"{where}: indentation outside the subset")
        if key in target:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if value:
            target[key] = _scalar(value, where)
        elif target is out:
            target[key], open_key = None, key
        else:
            raise ValueError(f"{where}: more than one level of nesting")
    return out


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        mant, e, exp = text.partition("e")
        if "." not in mant:
            mant += ".0"
        return mant + (e + exp if e else "")
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(i) for i in v) + "]"
    raise ValueError(f"save_yaml cannot write a {type(v).__name__}")


def save_yaml(data: Dict[str, Any], file_path: str) -> None:
    """Writes a flat dict of scalars and flat lists (the CLI's args.yaml
    and avg_metrics.yaml) in the subset, keys sorted as yaml.dump sorts
    them; `yaml.safe_load` and `load_yaml` read it back unchanged."""
    lines = []
    for key in sorted(data):
        if not _KEY.fullmatch(key):
            raise ValueError(f"save_yaml: key {key!r} is outside the subset")
        lines.append(f"{key}: {_dump_scalar(data[key])}")
    with open(file_path, "w") as f:
        f.write("\n".join(lines) + "\n")
