"""Posterior sampling API (PyTorch port of `kdip_tpu/sampling_api.py`):
build the guided denoiser for a measurement and run a Karras sampler (Heun,
Euler or DPM-Solver++(2M)) over the Karras schedule; `posterior_sample`
builds and calls it once."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import diffusion as diff
from . import guidance as gd
from . import samplers, schedules
from .autoi import rademacher
from .operators import Measurement
from .profiling import span

SAMPLERS = {"heun": samplers.sample_heun, "euler": samplers.sample_euler,
            "dpmpp_2m": samplers.sample_dpmpp_2m}


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler settings (defaults = the reference CLI's,
    sample_condition_openai.py:89-92, 186-194). per_sample_map runs each of
    n samples that share one measurement through its own denoiser call, and
    so its own CG solve, as `kdip_tpu` does by default. sampler is "heun",
    "euler" or "dpmpp_2m" (no churn)."""
    steps: int = 50
    sigma_min: float = 1e-2
    sigma_max: float = 80.0
    rho: float = 7.0
    sampler: str = "heun"
    ode: bool = False       # True disables churn
    s_churn: float = 80.0
    s_tmin: float = 0.05
    s_tmax: float = 50.0
    s_noise: float = 1.003
    per_sample_map: bool = True


def build_posterior_sampler(model_apply: Callable,
                            tables: diff.DiffusionTables, operator,
                            guidance_cfg: gd.GuidanceConfig,
                            sampler_cfg: SamplerConfig = SamplerConfig(),
                            recon_mse: Optional[Dict[str, object]] = None,
                            v2: bool = False, image_size: int = 256,
                            channels: int = 3, device="cuda",
                            uncond_pair=None):
    """Returns `sample(measurement, n=1, ...) -> hat_x0` ([n, C, H, W]).

    model_apply(x_scaled, t) is the raw ADMUNet (v1) or the ADMUNetV2 (v2)
    forward; the model modules themselves qualify. `uncond_pair`, an
    (uncond_pred, x0_var_fn) pair, replaces the OpenAI factories for
    another model family (`guidance.make_kdiff_v2_uncond`; pass v2=True
    for its variance pair). recon_mse is the
    analytic covariance's table ({"sigmas", "mse_list"}). The sampler runs
    on `device`; the model, tables, operator and measurement must live
    there.
    """
    if sampler_cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler_cfg.sampler!r}")
    warm = guidance_cfg.cg_warm_start
    if warm and sampler_cfg.sampler == "dpmpp_2m":
        # kdip_tpu's assert (sampling_api.py:82-85)
        raise ValueError("cg_warm_start is carried by the heun and euler "
                         "samplers, not dpmpp_2m")
    sigmas = schedules.get_sigmas_karras(sampler_cfg.steps,
                                         sampler_cfg.sigma_min,
                                         sampler_cfg.sigma_max,
                                         sampler_cfg.rho)
    if uncond_pair is not None:
        uncond, var_fn = uncond_pair
    elif v2:
        uncond, var_fn = gd.make_openai_v2_uncond(model_apply, tables,
                                                  guidance_cfg)
    else:
        uncond, var_fn = gd.make_openai_uncond(model_apply, tables,
                                               guidance_cfg, recon_mse)
    base = guidance_cfg.guidance.split("+")[0]
    if base == "stsl":
        n_probes, draw = guidance_cfg.num_hutchinson_samples, torch.randn
    elif base == "autoI":
        n_probes, draw = guidance_cfg.num_probes, rademacher
    else:
        n_probes = 0
    kw = {}
    if sampler_cfg.sampler != "dpmpp_2m" and not sampler_cfg.ode:
        kw = dict(s_churn=sampler_cfg.s_churn, s_tmin=sampler_cfg.s_tmin,
                  s_tmax=sampler_cfg.s_tmax, s_noise=sampler_cfg.s_noise)
    sampler_fn = SAMPLERS[sampler_cfg.sampler]

    def sample(measurement: Measurement, n: int = 1,
               generator: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None,
               noise_fn: Optional[Callable] = None,
               probe_fn: Optional[Callable[[int], Sequence[torch.Tensor]]]
               = None, return_info: bool = False,
               shard: Optional[Tuple[int, int]] = None):
        """init_noise (standard normal [n, C, H, W]; scaled by sigma_max
        here), noise_fn (the Euler and Heun samplers' churn noise per step,
        see samplers.sample_heun) and probe_fn (stsl's or autoI's probes
        of the k-th guided call, probe_fn(k)) inject the randomness;
        otherwise it comes from `generator`. return_info also returns the
        samplers' info dict. With cg_warm_start every sample carries its
        own solver state through the trajectory.

        With `shard` = (rank, world) the n samples are a rank's block of a
        batch of n * world (`parallel.sharding.make_sharded_sampler`):
        every draw, and the injected init_noise, noise_fn(i) and
        probe_fn(k), is of the whole batch, in this sampler's order, and
        the rank keeps its block, so the ranks together draw what one
        process would. The call is one request span,
        `profiling.span("sampling_api.sample", request=True)`."""
        with span("sampling_api.sample", request=True):
            if shard is not None:
                init_noise, noise_fn, probe_fn = _block_draws(
                    shard, (n, channels, image_size, image_size), generator,
                    device, init_noise, noise_fn, probe_fn,
                    (n_probes, draw) if n_probes else None)
            denoise = gd.make_condition_denoiser(
                uncond, var_fn, operator, measurement, guidance_cfg, v2=v2,
                with_info=return_info or warm, generator=generator)
            mapped = (sampler_cfg.per_sample_map and n > 1
                      and measurement.y.shape[0] == 1)
            batch = 1 if mapped else n
            shape = (batch, channels, image_size, image_size)
            state = None
            if warm:
                # n states of batch 1 under the per-sample loop, as
                # kdip_tpu's lax.map slices one stacked state
                # (sampling_api.py:97-111)
                state = gd.init_solver_state(operator, shape, device)
                if mapped:
                    state = [gd.init_solver_state(operator, shape, device)
                             for _ in range(n)]
            if mapped:
                denoise = _per_sample(denoise, return_info or warm)
            if n_probes:
                denoise = _shared_probes(denoise, probe_fn or (
                    lambda k: [draw(shape, generator=generator,
                                    device=device)
                               for _ in range(n_probes)]))
            if init_noise is None:
                init_noise = torch.randn(
                    (n, channels, image_size, image_size),
                    generator=generator, device=device)
            x = init_noise.to(device) * sampler_cfg.sigma_max
            if sampler_cfg.sampler == "dpmpp_2m":
                return sampler_fn(denoise, x, sigmas,
                                  return_info=return_info)
            out = sampler_fn(denoise, x, sigmas, noise_fn=noise_fn,
                             generator=generator,
                             return_info=return_info or warm,
                             solver_state=state, **kw)
            return out[0] if warm and not return_info else out

    return sample


def posterior_sample(model_apply: Callable, tables: diff.DiffusionTables,
                     operator, measurement: Measurement,
                     generator: Optional[torch.Generator] = None,
                     guidance_cfg: Optional[gd.GuidanceConfig] = None,
                     sampler_cfg: Optional[SamplerConfig] = None,
                     n: int = 1, init_noise: Optional[torch.Tensor] = None,
                     noise_fn: Optional[Callable] = None, **kw):
    """One-shot wrapper (`kdip_tpu` sampling_api.py:151-159):
    build_posterior_sampler(**kw), then one call on `measurement` with n
    samples. The randomness comes from `generator` (`kdip_tpu`'s key), or
    from injected `init_noise` and `noise_fn` as in that call."""
    sampler = build_posterior_sampler(
        model_apply, tables, operator, guidance_cfg or gd.GuidanceConfig(),
        sampler_cfg or SamplerConfig(), **kw)
    return sampler(measurement, n=n, generator=generator,
                   init_noise=init_noise, noise_fn=noise_fn)


def _block_draws(shard, local_shape, generator, device, init_noise,
                 noise_fn, probe_fn, probes):
    """(init_noise, noise_fn, probe_fn) of a rank's block: the whole
    batch's init noise, churn noise per step and probes per guided call
    ([n * world, C, H, W] each, injected or drawn from `generator` in the
    unsharded sampler's order; `probes` = (count, draw) or None), cut to
    the rank's rows."""
    (r, w), n = shard, local_shape[0]
    shape = (n * w,) + tuple(local_shape[1:])

    def take(t):
        return t[r * n:(r + 1) * n]

    def whole(fn=torch.randn):
        return fn(shape, generator=generator, device=device)
    whole_noise = noise_fn or (lambda i: whole())
    whole_probes = probe_fn
    if probes is not None and probe_fn is None:
        count, fn = probes

        def whole_probes(k):
            return [whole(fn) for _ in range(count)]

    def block_probes(k):
        return [take(p) for p in whole_probes(k)]
    return (take(whole() if init_noise is None else init_noise),
            lambda i: take(whole_noise(i)),
            block_probes if probes is not None else None)


def _per_sample(denoise: Callable, with_info: bool) -> Callable:
    """Runs `denoise` on one sample at a time (`kdip_tpu`'s lax.map,
    sampling_api.py:110-132), each with the call's keyword arguments and,
    with the warm start, its own entry of the list `solver_state`; the
    info reports the worst residual, the summed CG iterations and the
    samples' new states."""
    def mapped(x, sigma, solver_state=None, **kw):
        outs = []
        for i in range(x.shape[0]):
            if solver_state is not None:
                kw["solver_state"] = solver_state[i]
            outs.append(denoise(x[i:i + 1], sigma, **kw))
        if not with_info:
            return torch.cat(outs)
        infos = [info for _, info in outs]
        info = {"cg_resid": max(i["cg_resid"] for i in infos),
                "cg_iters": sum(i["cg_iters"] for i in infos)}
        if solver_state is not None:
            info["solver_state"] = [i["solver_state"] for i in infos]
        return torch.cat([o for o, _ in outs]), info
    return mapped


def _shared_probes(denoise: Callable, probe_fn: Callable) -> Callable:
    """stsl's or autoI's probes, drawn once per guided call (probe_fn(k)
    for the k-th) and given to every sample of it, as `kdip_tpu`'s lax.map
    passes one key, and so one set of probes, to every sample of a call
    (sampling_api.py:126-132)."""
    calls = 0

    def call(x, sigma):
        nonlocal calls
        eps = probe_fn(calls)
        calls += 1
        return denoise(x, sigma, probes=eps)
    return call
