"""Flag-compatible model and diffusion factories and argparse bridges
(PyTorch port of `kdip_tpu/script_util.py`; ref:
guided_diffusion/script_util.py:11-453), returning the port's modules and
its DiffusionTables:

- the defaults dicts: diffusion_defaults, classifier_defaults,
  model_and_diffusion_defaults, classifier_and_diffusion_defaults,
  sr_model_and_diffusion_defaults;
- create_model_and_diffusion, create_model, create_gaussian_diffusion;
- create_classifier_and_diffusion (create_classifier is in models.adm);
- sr_create_model_and_diffusion, sr_create_model;
- add_dict_to_argparser, args_to_dict, str2bool.

`create_gaussian_diffusion` returns a DiffusionSpec: the tables plus the
switches the reference keeps as SpacedDiffusion attributes. Every factory
takes a keyword `device` (default "cuda"); `use_fp16` builds a bfloat16
torso, as `kdip_tpu`'s does.
"""

from __future__ import annotations

import argparse
import inspect
from typing import NamedTuple

import torch

from . import diffusion
from .models import adm

NUM_CLASSES = 1000  # (ref: script_util.py:9)


class DiffusionSpec(NamedTuple):
    """Tables + the reference's mean/var/loss-type switches."""
    tables: diffusion.DiffusionTables
    learn_sigma: bool = False
    sigma_small: bool = False
    predict_xstart: bool = False
    rescale_timesteps: bool = False
    loss_type: str = "mse"


def diffusion_defaults():
    """(ref: script_util.py:11-24)"""
    return dict(
        learn_sigma=False,
        diffusion_steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
    )


def classifier_defaults():
    """(ref: script_util.py:27-40)"""
    return dict(
        image_size=64,
        classifier_use_fp16=False,
        classifier_width=128,
        classifier_depth=2,
        classifier_attention_resolutions="32,16,8",
        classifier_use_scale_shift_norm=True,
        classifier_resblock_updown=True,
        classifier_pool="attention",
    )


def model_and_diffusion_defaults():
    """(ref: script_util.py:43-65)"""
    res = dict(
        image_size=64,
        num_channels=128,
        num_res_blocks=2,
        num_heads=4,
        num_heads_upsample=-1,
        num_head_channels=-1,
        attention_resolutions="16,8",
        channel_mult="",
        dropout=0.0,
        class_cond=False,
        use_checkpoint=False,
        use_scale_shift_norm=True,
        resblock_updown=False,
        use_fp16=False,
        use_new_attention_order=False,
    )
    res.update(diffusion_defaults())
    return res


def classifier_and_diffusion_defaults():
    """(ref: script_util.py:68-71)"""
    res = classifier_defaults()
    res.update(diffusion_defaults())
    return res


def _dtype(use_fp16: bool):
    return torch.bfloat16 if use_fp16 else torch.float32


def create_model_and_diffusion(
        image_size, class_cond, learn_sigma, num_channels, num_res_blocks,
        channel_mult, num_heads, num_head_channels, num_heads_upsample,
        attention_resolutions, dropout, diffusion_steps, noise_schedule,
        timestep_respacing, use_kl, predict_xstart, rescale_timesteps,
        rescale_learned_sigmas, use_checkpoint, use_scale_shift_norm,
        resblock_updown, use_fp16, use_new_attention_order, *,
        device="cuda"):
    """(ref: script_util.py:74-127). Returns (ADMUNet, DiffusionSpec)."""
    model = create_model(
        image_size, num_channels, num_res_blocks, channel_mult=channel_mult,
        learn_sigma=learn_sigma, class_cond=class_cond,
        use_checkpoint=use_checkpoint,
        attention_resolutions=attention_resolutions, num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm, dropout=dropout,
        resblock_updown=resblock_updown, use_fp16=use_fp16,
        use_new_attention_order=use_new_attention_order, device=device)
    spec = create_gaussian_diffusion(
        steps=diffusion_steps, learn_sigma=learn_sigma,
        noise_schedule=noise_schedule, use_kl=use_kl,
        predict_xstart=predict_xstart, rescale_timesteps=rescale_timesteps,
        rescale_learned_sigmas=rescale_learned_sigmas,
        timestep_respacing=timestep_respacing, device=device)
    return model, spec


def create_model(image_size, num_channels, num_res_blocks, channel_mult="",
                 learn_sigma=False, class_cond=False, use_checkpoint=False,
                 attention_resolutions="16", num_heads=1,
                 num_head_channels=-1, num_heads_upsample=-1,
                 use_scale_shift_norm=False, dropout=0.0,
                 resblock_updown=False, use_fp16=False,
                 use_new_attention_order=False, *,
                 device="cuda") -> adm.ADMUNet:
    """(ref: script_util.py:130-184): `adm.create_unet` with
    guided-diffusion's defaults and the torso dtype from use_fp16.
    use_checkpoint (gradient checkpointing) is accepted for the flags'
    sake and unused; `dropout` is live under train()."""
    del use_checkpoint
    return adm.create_unet(
        image_size, num_channels, num_res_blocks, channel_mult=channel_mult,
        learn_sigma=learn_sigma, class_cond=class_cond,
        attention_resolutions=attention_resolutions, num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm, dropout=dropout,
        resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order,
        dtype=_dtype(use_fp16), device=device)


def create_classifier_and_diffusion(
        image_size, classifier_use_fp16, classifier_width, classifier_depth,
        classifier_attention_resolutions, classifier_use_scale_shift_norm,
        classifier_resblock_updown, classifier_pool, learn_sigma,
        diffusion_steps, noise_schedule, timestep_respacing, use_kl,
        predict_xstart, rescale_timesteps, rescale_learned_sigmas, *,
        device="cuda"):
    """(ref: script_util.py:187-225). Returns (EncoderADMUNet,
    DiffusionSpec)."""
    classifier = adm.create_classifier(
        image_size=image_size, classifier_use_fp16=classifier_use_fp16,
        classifier_width=classifier_width, classifier_depth=classifier_depth,
        classifier_attention_resolutions=classifier_attention_resolutions,
        classifier_use_scale_shift_norm=classifier_use_scale_shift_norm,
        classifier_resblock_updown=classifier_resblock_updown,
        classifier_pool=classifier_pool, out_channels=NUM_CLASSES,
        device=device)
    spec = create_gaussian_diffusion(
        steps=diffusion_steps, learn_sigma=learn_sigma,
        noise_schedule=noise_schedule, use_kl=use_kl,
        predict_xstart=predict_xstart, rescale_timesteps=rescale_timesteps,
        rescale_learned_sigmas=rescale_learned_sigmas,
        timestep_respacing=timestep_respacing, device=device)
    return classifier, spec


def sr_model_and_diffusion_defaults():
    """(ref: script_util.py:269-277)"""
    res = model_and_diffusion_defaults()
    res["large_size"] = 256
    res["small_size"] = 64
    arg_names = inspect.getfullargspec(sr_create_model_and_diffusion)[0]
    for k in list(res):
        if k not in arg_names:
            del res[k]
    return res


def sr_create_model_and_diffusion(
        large_size, small_size, class_cond, learn_sigma, num_channels,
        num_res_blocks, num_heads, num_head_channels, num_heads_upsample,
        attention_resolutions, dropout, diffusion_steps, noise_schedule,
        timestep_respacing, use_kl, predict_xstart, rescale_timesteps,
        rescale_learned_sigmas, use_checkpoint, use_scale_shift_norm,
        resblock_updown, use_fp16, *, device="cuda"):
    """(ref: script_util.py:280-331)"""
    model = sr_create_model(
        large_size, small_size, num_channels, num_res_blocks,
        learn_sigma=learn_sigma, class_cond=class_cond,
        use_checkpoint=use_checkpoint,
        attention_resolutions=attention_resolutions, num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm, dropout=dropout,
        resblock_updown=resblock_updown, use_fp16=use_fp16, device=device)
    spec = create_gaussian_diffusion(
        steps=diffusion_steps, learn_sigma=learn_sigma,
        noise_schedule=noise_schedule, use_kl=use_kl,
        predict_xstart=predict_xstart, rescale_timesteps=rescale_timesteps,
        rescale_learned_sigmas=rescale_learned_sigmas,
        timestep_respacing=timestep_respacing, device=device)
    return model, spec


def sr_create_model(large_size, small_size, num_channels, num_res_blocks,
                    learn_sigma, class_cond, use_checkpoint,
                    attention_resolutions, num_heads, num_head_channels,
                    num_heads_upsample, use_scale_shift_norm, dropout,
                    resblock_updown, use_fp16, *,
                    device="cuda") -> adm.SuperResADMUNet:
    """(ref: script_util.py:334-383)"""
    del small_size, use_checkpoint
    if large_size in (512, 256):
        channel_mult = (1, 1, 2, 2, 4, 4)
    elif large_size == 64:
        channel_mult = (1, 2, 3, 4)
    else:
        raise ValueError(f"no channel multiplier preset for large size "
                         f"{large_size}")
    attention_ds = tuple(large_size // int(res)
                         for res in attention_resolutions.split(","))
    return adm.SuperResADMUNet(
        image_size=large_size, in_channels=6,  # image + upsampled low-res
        model_channels=num_channels, out_channels=(6 if learn_sigma else 3),
        num_res_blocks=num_res_blocks, attention_resolutions=attention_ds,
        channel_mult=channel_mult,
        num_classes=(NUM_CLASSES if class_cond else None),
        num_heads=num_heads, num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown, dropout=dropout,
        dtype=_dtype(use_fp16), device=device)


def create_gaussian_diffusion(*, steps=1000, learn_sigma=False,
                              sigma_small=False, noise_schedule="linear",
                              use_kl=False, predict_xstart=False,
                              rescale_timesteps=False,
                              rescale_learned_sigmas=False,
                              timestep_respacing="",
                              device="cuda") -> DiffusionSpec:
    """(ref: script_util.py:386-424): the SpacedDiffusion object becomes
    DiffusionTables on `device` plus the switches in a NamedTuple."""
    if use_kl:
        loss_type = "rescaled_kl"
    elif rescale_learned_sigmas:
        loss_type = "rescaled_mse"
    else:
        loss_type = "mse"
    tables = diffusion.make_diffusion(
        steps, noise_schedule,
        timestep_respacing=timestep_respacing or None, device=device)
    return DiffusionSpec(tables=tables, learn_sigma=learn_sigma,
                         sigma_small=sigma_small,
                         predict_xstart=predict_xstart,
                         rescale_timesteps=rescale_timesteps,
                         loss_type=loss_type)


def add_dict_to_argparser(parser, default_dict):
    """(ref: script_util.py:427-434)"""
    for k, v in default_dict.items():
        v_type = type(v)
        if v is None:
            v_type = str
        elif isinstance(v, bool):
            v_type = str2bool
        parser.add_argument(f"--{k}", default=v, type=v_type)


def args_to_dict(args, keys):
    """(ref: script_util.py:437-438)"""
    return {k: getattr(args, k) for k in keys}


def str2bool(v):
    """(ref: script_util.py:441-452)"""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")
