"""The OpenAI ADM family (guided-diffusion's UNet, with the DWT/DCT-Var
head under "v2"): how the program builds a configuration's model and
sampler, and how the reference builds its own. A configuration names its
family in "family"; another family adds a file beside this one."""

from __future__ import annotations

import torch


def program_model(cfg: dict, state: dict, device):
    """The program's model and DDPM tables, as its sampling CLI makes them
    (`config.make_openai_model`, the V2 head, `weights.precast_inference`
    under a bfloat16 precision), holding the benchmark's weights."""
    from kdip_tpu_torch import config, weights
    from kdip_tpu_torch.models import adm
    mc = cfg["model"]
    with torch.device(device):
        model, tables = config.make_openai_model(
            {"openai": mc["openai"]}, winograd=cfg["winograd"],
            device=device)
        if mc.get("v2"):
            model = adm.ADMUNetV2(model)
    model.load_state_dict(state, strict=True)
    if cfg["precision"] == "bfloat16":
        weights.precast_inference(model)
    elif cfg["precision"] != "float32":
        raise ValueError(f"precision {cfg['precision']!r}")
    return model.eval().requires_grad_(False), tables


def program_sampler(cfg: dict, traffic: dict, model_apply, tables,
                    operator, device, sampler_overrides=None):
    """`sampling_api.build_posterior_sampler` over `model_apply` with the
    configuration's guidance and the mix's sampler."""
    from kdip_tpu_torch import guidance, sampling_api
    g, s, mc = cfg["guidance"], traffic["sampler"], cfg["model"]
    gcfg = guidance.GuidanceConfig(
        guidance=g["guidance"], x0_cov_type=g["x0_cov_type"],
        mle_sigma_thres=g["mle_sigma_thres"],
        ortho_tf_type=g["ortho_tf_type"], cg_tol=g["cg_tol"],
        cg_maxiter=g["cg_maxiter"])
    kw = dict(steps=s["steps"], sigma_min=mc["sigma_min"],
              sigma_max=mc["sigma_max"], rho=s["rho"],
              s_churn=s["s_churn"], s_tmin=s["s_tmin"], s_tmax=s["s_tmax"],
              s_noise=s["s_noise"], sampler=s["sampler"])
    kw.update(sampler_overrides or {})
    return sampling_api.build_posterior_sampler(
        model_apply, tables, operator, gcfg, sampling_api.SamplerConfig(**kw),
        v2=bool(mc.get("v2")), image_size=mc["openai"]["image_size"],
        channels=3, device=device)


def reference_model(cfg: dict, q=None) -> torch.nn.Module:
    """The reference model on the meta device (shapes only; `to_empty`
    and a state dict make it real)."""
    from reference import adm
    with torch.device("meta"):
        return adm.build(cfg["model"], q)


def norm_names(model) -> set:
    from reference import adm
    return adm.norm_weight_names(model)


def reference_moments(cfg: dict, model, device):
    from reference import adm, guided
    f = cfg["model"]["openai"]
    if f["noise_schedule"] != "linear" or f["timestep_respacing"]:
        raise ValueError("the reference has the unrespaced linear schedule")
    tables = guided.linear_tables(f["diffusion_steps"], device)
    return adm.moments(model, tables, bool(cfg["model"].get("v2")))
