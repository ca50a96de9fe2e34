"""The comparison that decides `correct`: what the timed path produced at a
sample of Heun steps of the window's first solve, against the reference.

The sample, drawn from the seed, is step 0 and `check.closed_steps` steps
whose two guided calls lie above the guidance threshold (the closed-form
solve) and `check.cg_steps` below it (the joint CG). For a step i the
model's inputs at calls 2i, 2i+1 and 2i+2 give the program's states x_hat
(at sigma_hat), x_2 (at sigma_next) and the next step's x_hat, from which,
with the churn the benchmark drew, its Heun step gives back the x0
estimate of each call:

    D_1 = x_hat - sigma_hat (x_2 - x_hat) / dt
    D_2 = x_2 - sigma_next (2 (x_next - x_hat) / dt - (x_2 - x_hat) / dt)

(in float64). The reference computes each call's x0 estimate from the same
state, step 0's from its own start (the benchmark's initial noise), and
the model's outputs there. So the reference follows the program step by
step from the program's own state; step 0 checks the start.

Numbers, each a relative squared error |a - b|^2 / |b|^2 (2-norms over
the batch), the worst over the sampled calls:
- `unet_err`: of each model output;
- `step_err_closed`: of the Heun direction d = (x - D) / sigma that the
  call's x0 estimate D sets, |D - D_ref|^2 / |x - D_ref|^2, calls above
  the threshold;
- `step_err_cg`: the same, calls below it.
Far above the threshold D is nearly all clamped at +-1 and flips sign
where bfloat16 moves a huge pre-clamp value across 0, while the step
barely feels D; the direction weighs D's error by what it does to the
step. Squared errors, because they count flipped pixels linearly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import inputs
from reference import guided

NUMBERS = ("unet_err", "step_err_closed", "step_err_cg")


def sampled_steps(sch: guided.Schedule, thres: float, seed: int,
                  n_closed: int, n_cg: int) -> List[int]:
    """Step 0, and n_closed steps whose calls both lie above the threshold
    and n_cg below it, each drawn from its own equal stretch of its
    regime's steps (so both ends of each regime are in every sample)."""
    cands = range(1, sch.steps - 1)
    closed = [i for i in cands if sch.sigma_hat(i) >= thres
              and sch.sigmas[i + 1] >= thres]
    cg = [i for i in cands if sch.sigma_hat(i) < thres
          and sch.sigmas[i + 1] < thres]
    rng = np.random.default_rng(inputs.mix(seed, "check"))
    pick = {0}
    for steps, n in ((closed, n_closed), (cg, n_cg)):
        for part in np.array_split(np.asarray(steps, dtype=np.int64),
                                   min(n, len(steps))):
            pick.add(int(rng.choice(part)))
    return sorted(pick)


def calls_of(steps: List[int]):
    """(calls whose input is kept, calls whose output is kept)."""
    inp = {c for i in steps for c in (2 * i, 2 * i + 1, 2 * i + 2)}
    out = {c for i in steps for c in (2 * i, 2 * i + 1)}
    return inp, out


def err(a, b) -> float:
    """|a - b|^2 / |b|^2."""
    a, b = a.double(), b.double()
    return float((a - b).square().sum() / b.square().sum().clamp(
        min=1e-300))


def step_err(d, d_ref, x) -> float:
    """|d - d_ref|^2 / |x - d_ref|^2."""
    d, d_ref, x = d.double(), d_ref.double(), x.double()
    return float((d - d_ref).square().sum()
                 / (x - d_ref).square().sum().clamp(min=1e-300))


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


def program_x0(cap_x: Dict[int, torch.Tensor], i: int, sch: guided.Schedule,
               churn_next: Optional[torch.Tensor]):
    """(D_1, D_2) of step i from the program's states (float64)."""
    sh, sn = sch.sigma_hat(i), sch.sigmas[i + 1]
    dt = float(sn - sh)
    xh = cap_x[2 * i].double() / guided.c_in(sh)
    x2 = cap_x[2 * i + 1].double() / guided.c_in(sn)
    xn = cap_x[2 * i + 2].double() / guided.c_in(sch.sigma_hat(i + 1))
    bump = sch.bump(i + 1)
    if bump:
        xn = xn - churn_next.double() * sch.s_noise * bump
    d1 = (x2 - xh) / dt
    d2 = 2 * (xn - xh) / dt - d1
    return xh - float(sh) * d1, x2 - float(sn) * d2


def compare(steps: List[int], sch: guided.Schedule, cap_x, cap_out,
            start: torch.Tensor, churn: Callable[[int], torch.Tensor],
            problem, gcfg: Dict, moments: Callable,
            controls: Dict[str, Callable]) -> Dict:
    """The numbers of the program and of each control (a reference at
    another precision put in the program's place) against `moments`, the
    reference, with each call's readings."""
    thres = gcfg["mle_sigma_thres"]
    worst = {"program": {}, **{n: {} for n in controls}}
    rows = []

    def note(who, key, v, row):
        row.setdefault(who, {})[key] = v
        worst[who][key] = max(worst[who].get(key, 0.0), v)

    for i in steps:
        d_prog = program_x0(cap_x, i, sch, churn(i + 1)
                            if sch.bump(i + 1) else None)
        x_hat = (start if i == 0 else
                 (cap_x[2 * i].double() / guided.c_in(sch.sigma_hat(i))
                  ).float())
        x_2 = (cap_x[2 * i + 1].double()
               / guided.c_in(sch.sigmas[i + 1])).float()
        for k, (x, s) in enumerate(((x_hat, float(sch.sigma_hat(i))),
                                    (x_2, float(sch.sigmas[i + 1])))):
            row = {"call": 2 * i + k, "sigma": s}
            key = "step_err_cg" if s < thres else "step_err_closed"
            d_ref, raw = guided.guided_x0(moments, problem, gcfg, x, s)
            note("program", "unet_err", max(err(p, r) for p, r in zip(
                _outs(cap_out[2 * i + k]), _outs(raw))), row)
            note("program", key, step_err(d_prog[k], d_ref, x), row)
            for n, cm in controls.items():
                d_c, raw_c = guided.guided_x0(cm, problem, gcfg, x, s)
                note(n, "unet_err", max(err(p, r) for p, r in zip(
                    _outs(raw_c), _outs(raw))), row)
                note(n, key, step_err(d_c, d_ref, x), row)
            rows.append(row)
    return {"numbers": {k: worst["program"].get(k) for k in NUMBERS},
            "controls": {n: {k: worst[n].get(k) for k in NUMBERS}
                         for n in controls},
            "calls": rows}
