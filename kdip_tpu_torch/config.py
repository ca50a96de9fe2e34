"""JSON experiment configs and the OpenAI model factory (PyTorch port of
`kdip_tpu/config.py:59-113`; ref: k_diffusion/config.py,
guided_diffusion/script_util.py).

`make_openai_model` builds (ADMUNet, DiffusionTables) from a config's
"model" block as the sampling CLI does, `winograd=` included. Only the
OpenAI family and JSON files are ported.

`load_yaml` / `save_yaml` read and write the subset of YAML that the
operator configs and the CLI's artefacts use, without PyYAML (which the
card's machine may lack): `key: value` lines, one level of indented
nesting, JSON scalars and inline lists, bare strings and `#` comments
(`save_yaml` writes the CLI's flat maps only). Anything outside it raises
a ValueError that names the line.
"""

from __future__ import annotations

import json
import math
import re
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
