"""`correct` holds a sound run and refuses a broken one, at a size a test
run can hold (tiny cells on the CPU under the full-size cells' limits):

- the control, the reference computed in float8 put in the program's
  place, fails at least one number while the program passes all;
- a run drives the rest of the harness with the timed path broken
  underneath and comes out not correct, once for each fault the cells can
  have: a Heun step that returns its state unchanged, half of the batch
  left out with the mean of the rest in its place, and an answer (a call's
  x0 estimate) altered where it is produced. The cells run on one chip,
  so there is no exchange between chips to leave out.

The card's own readings, at the cells' sizes, come from control.py; the
`cuda` test here runs it for one seed."""

import json
import os
import subprocess
import sys

import pytest
import torch

import tiny
import run as run_py


def _correct(cell, res):
    return run_py.result_line(cell, res, False, "cpu", 1)["correct"]


@pytest.mark.parametrize("kind", ["dwt_var", "winograd_convert"])
def test_the_program_passes_and_the_control_fails(kind):
    c = tiny.cell(kind)
    res = tiny.run(c, controls=("fp8",))
    assert _correct(c, res), res["check"]["numbers"]
    ctrl = res["check"]["controls"]["fp8"]
    assert any(ctrl[k] > c.limits[k] for k in c.limits), ctrl


def _unchanged_state(monkeypatch):
    from kdip_tpu_torch import samplers
    monkeypatch.setattr(samplers, "to_d",
                        lambda x, sigma, denoised: torch.zeros_like(x))


def _half_batch(monkeypatch):
    from kdip_tpu_torch.models import adm
    forward = adm.ADMUNet.forward

    def half(self, x, t, *a, **k):
        n = x.shape[0] // 2
        out = forward(self, x[:n], t[:n], *a, **k)

        def fill(o):
            return torch.cat([o, o.mean(0, keepdim=True).expand_as(o)])
        return tuple(fill(o) for o in out) if isinstance(out, tuple) \
            else fill(out)
    monkeypatch.setattr(adm.ADMUNet, "forward", half)


def _altered_answer(monkeypatch):
    from kdip_tpu_torch import guidance
    make = guidance.make_condition_denoiser

    def altered(*a, **k):
        den = make(*a, **k)

        def call(x, sigma, **kw):
            out, info = den(x, sigma, **kw)
            out = out.clone()
            out[0] += 0.02
            return out, info
        return call
    monkeypatch.setattr(guidance, "make_condition_denoiser", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize("kind", ["dwt_var", "winograd_convert"])
def test_a_broken_timed_path_is_not_correct(kind, fault, monkeypatch):
    c = tiny.cell(kind)
    fault(monkeypatch)
    res = tiny.run(c)
    assert not _correct(c, res), res["check"]["numbers"]


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_the_cells_size():
    """control.py on the card for one seed of the b8 cell: the program
    within every limit, the float8 control past one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH, "control.py"),
         "--workload", "ffhq_dwt_var.inpaint.b8", "--seeds", "7"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    row = json.loads(r.stdout.splitlines()[0])
    limits = tiny._json("limits", "ffhq_dwt_var.inpaint.b8.json")
    assert all(row["program"][k] <= v for k, v in limits.items())
    assert any(row["controls"]["fp8"][k] > v for k, v in limits.items())
