"""The span recorder of `kdip_tpu_torch.profiling` inside the guided solve,
and the solves' host-read counter (`guidance.host_read_counts`), on the
CPU: a tiny guided Heun solve gives bit-equal outputs, CG iterations,
matvecs and host reads with the recorder on and off; with it on, the
spans form the solve's tree (one request a call, one step a sampler step,
one NFE a model call, each NFE's forward, vjp and solve, each host read
inside its solve); with it off nothing is recorded."""

import threading

import pytest
import torch
from torch import nn

import kdip_tpu_torch as P
from kdip_tpu_torch import guidance, profiling
from kdip_tpu_torch.ops import dwt

S, B = 32, 2
UNET = dict(image_size=S, in_channels=3, model_channels=32, out_channels=6,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=4, num_head_channels=16)
# DWT-Var: Type-I with the learned DWT covariance, a CG below sigma 1;
# Convert with its threshold below sigma_min: every solve closed-form
KINDS = {"dwt_var": (True, dict(guidance="I", x0_cov_type="convert",
                                mle_sigma_thres=1.0, ortho_tf_type="dwt")),
         "convert": (False, dict(guidance="I", x0_cov_type="convert",
                                 mle_sigma_thres=1e-3))}
STEPS, SIGMA_MAX = 4, 5.0


@pytest.fixture(autouse=True)
def _one_thread_recorder_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_spans()
    yield
    profiling.take_spans()
    torch.set_num_threads(n)


def _model(v2: bool):
    g = torch.Generator().manual_seed(3)
    unet = P.adm.ADMUNet(**UNET, device="cpu")
    model = P.adm.ADMUNetV2(unet) if v2 else unet
    with torch.no_grad():
        for m in model.modules():
            for name, p in m.named_parameters(recurse=False):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
                if isinstance(m, nn.GroupNorm) and name == "weight":
                    p.add_(1.0)
    return model.eval().requires_grad_(False)


class _Counting:
    """The model as the sampler's model_apply, counting its calls."""

    def __init__(self, model):
        self.model, self.calls = model, 0

    def __call__(self, x, t):
        self.calls += 1
        return self.model(x, t)


def _sampler(kind: str, steps: int = STEPS):
    v2, gkw = KINDS[kind]
    model = _Counting(_model(v2))
    g = torch.Generator().manual_seed(5)
    mask = (torch.rand((1, 1, S, S), generator=g) < 0.5).float()
    op = P.operators.InpaintingOperator(mask.repeat(1, 3, 1, 1), 0.05)
    x = torch.rand((B, 3, S, S), generator=g) * 2 - 1
    y = op.measure(x, noise=torch.randn(x.shape, generator=g)).y
    sample = P.sampling_api.build_posterior_sampler(
        model, P.diffusion.make_diffusion(1000, "linear", device="cpu"), op,
        guidance.GuidanceConfig(**gkw),
        P.sampling_api.SamplerConfig(steps=steps, sigma_max=SIGMA_MAX),
        v2=v2, image_size=S, device="cpu")
    init = torch.randn((B, 3, S, S), generator=g)
    churn = [torch.randn((B, 3, S, S), generator=g) for _ in range(steps)]

    def solve():
        return sample(P.operators.Measurement(y=y), n=B, init_noise=init,
                      noise_fn=churn.__getitem__, return_info=True)
    return solve, model


def _counted(fn, monkeypatch):
    """fn()'s result with the deltas of the host reads and the launch
    counters it caused, and its calls of the fused DWT matvec (the plain
    path on the CPU launches no kernel)."""
    matvecs = []
    real = dwt.ot_matvec

    def counting(*a, **k):
        matvecs.append(1)
        return real(*a, **k)
    monkeypatch.setattr(dwt, "ot_matvec", counting)
    reads0 = dict(guidance.host_read_counts)
    launches0 = dict(dwt.launch_counts) | dict(P.winograd.launch_counts)
    out = fn()
    reads = {k: v - reads0[k] for k, v in guidance.host_read_counts.items()}
    launches = {k: v - launches0[k] for k, v in
                (dict(dwt.launch_counts)
                 | dict(P.winograd.launch_counts)).items()}
    return out, reads, launches, len(matvecs)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_recorder_changes_nothing_of_the_solve(kind, monkeypatch):
    """Bit-equal samples, CG iterations, matvecs, launches and host reads
    with the recorder off and on; off records nothing."""
    solve, model = _sampler(kind)
    (x_off, info_off), reads_off, launches_off, mv_off = _counted(
        solve, monkeypatch)
    assert profiling.take_spans() == []
    calls_off, model.calls = model.calls, 0
    profiling.record_spans(True)
    (x_on, info_on), reads_on, launches_on, mv_on = _counted(
        solve, monkeypatch)
    spans = profiling.take_spans()
    assert torch.equal(x_on, x_off)
    assert info_on == info_off
    assert (reads_on, launches_on, mv_on, model.calls) == (
        reads_off, launches_off, mv_off, calls_off)
    assert len(spans) > model.calls
    if kind == "convert":
        assert info_on["cg_total_iters"] == 0 and mv_on == 0
        assert sum(reads_on.values()) == 0
    else:
        assert info_on["cg_total_iters"] > 0 and mv_on > 0


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_the_spans_are_the_solves_tree(monkeypatch):
    """One request span a call, whose index every span below it carries;
    one step span a sampler step and one noise draw in each; one NFE span
    a model call, its children the UNet forward, the solve and the vjp;
    each host read inside a solve; every span inside its parent's
    interval. The host reads are the counter's: each CG solve tests its
    residual once more than it iterates and reads its exit residual once,
    so iterations + 2 x the solves below the threshold."""
    solve, model = _sampler("dwt_var")
    profiling.record_spans(True)
    (_, info), reads, _, _ = _counted(solve, monkeypatch)
    spans = profiling.take_spans()
    assert [s.name for s in spans if s.parent == -1] == [
        "sampling_api.sample"]
    assert spans[0].name == "sampling_api.sample" and spans[0].request == 0
    assert all(s.request == 0 for s in spans)
    steps = [i for i, s in enumerate(spans) if s.name == "samplers.step"]
    assert len(steps) == STEPS
    assert all(spans[i].parent == 0 for i in steps)
    nfes = [i for i, s in enumerate(spans) if s.name == "guidance.nfe"]
    assert len(nfes) == model.calls == 2 * STEPS - 1
    for i in steps:
        kids = _children(spans, i)
        assert kids.count("samplers.noise") == 1
        assert kids.count("guidance.nfe") in (1, 2)
        assert set(kids) == {"samplers.noise", "guidance.nfe"}
    for i in nfes:
        assert _children(spans, i) == ["guidance.forward",
                                       "guidance.solve", "guidance.vjp"]
    for i, s in enumerate(spans):
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.parent < i
    solves = [i for i, s in enumerate(spans) if s.name == "guidance.solve"]
    host = [s for s in spans if s.name == "guidance.host_read"]
    assert all(spans[s.parent].name == "guidance.solve" for s in host)
    sched = P.schedules.get_sigmas_karras(STEPS, 1e-2, SIGMA_MAX, 7.0)
    assert len(solves) == len(nfes)
    cg_solves = reads["cg_exit"]
    assert 0 < cg_solves < len(nfes) and float(sched[-2]) < 1.0
    assert len(host) == sum(reads.values())
    assert reads == {"cg_residual": info["cg_total_iters"] + cg_solves,
                     "cg_exit": cg_solves, "iso_mean": 0}


def test_each_call_is_its_own_request(monkeypatch):
    """Two calls of the sampler: two request spans, and every span below
    each carries its request's index."""
    solve, _ = _sampler("convert", steps=2)
    profiling.record_spans(True)
    solve()
    solve()
    spans = profiling.take_spans()
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["sampling_api.sample"] * 2
    assert [spans[i].request for i in roots] == roots
    for i, s in enumerate(spans):
        want = roots[1] if i >= roots[1] else roots[0]
        assert s.request == want


def test_off_is_one_shared_no_op_and_records_nothing():
    a, b = profiling.span("x"), profiling.span("y", request=True)
    assert a is b
    with a:
        pass
    assert profiling.take_spans() == []
    profiling.record_spans(True)
    with profiling.span("kept"):
        pass
    profiling.record_spans(False)
    with profiling.span("dropped"):
        pass
    assert [s.name for s in profiling.take_spans()] == ["kept"]
    assert profiling.take_spans() == []


def test_only_the_recording_thread_is_recorded():
    """A span entered on another thread (the autograd engine's, say) is
    not recorded; the caller's span covers the wait."""
    profiling.record_spans(True)
    with profiling.span("caller"):
        t = threading.Thread(target=lambda: profiling.span("worker")
                             .__enter__())
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    spans = profiling.take_spans()
    assert [s.name for s in spans] == ["caller"]
    assert spans[0].parent == -1 and spans[0].request == -1


def test_a_span_still_open_when_taken_has_no_end():
    profiling.record_spans(True)
    outer = profiling.span("outer")
    outer.__enter__()
    with profiling.span("inner"):
        pass
    spans = profiling.take_spans()
    outer.__exit__(None, None, None)
    assert [(s.name, s.end_ns is None, s.parent) for s in spans] == [
        ("outer", True, -1), ("inner", False, 0)]


def test_the_iso_solves_mean_variance_is_one_counted_read():
    """An iso covariance handed a tensor variance reads its mean on the
    host once a solve, inside the solve's span."""
    mask = torch.ones(1, 3, 4, 4)
    op = P.operators.InpaintingOperator(mask, 0.05)

    def uncond(x, sigma):
        return x * 0.5, {}

    def var_fn(aux, sigma, mean_vjp=None, x_shape=None):
        return torch.full(x_shape, 0.25)
    den = guidance.make_condition_denoiser(
        uncond, var_fn, op, P.operators.Measurement(y=torch.zeros(1, 3, 4, 4)),
        guidance.GuidanceConfig(guidance="I", x0_cov_type="pgdm"))
    before = guidance.host_read_counts["iso_mean"]
    profiling.record_spans(True)
    den(torch.ones(1, 3, 4, 4), 0.5)
    spans = profiling.take_spans()
    assert guidance.host_read_counts["iso_mean"] == before + 1
    assert [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans] == [
        ("guidance.nfe", None), ("guidance.forward", "guidance.nfe"),
        ("guidance.solve", "guidance.nfe"),
        ("guidance.host_read", "guidance.solve"),
        ("guidance.vjp", "guidance.nfe")]


def test_reset_host_read_counts():
    guidance.host_read_counts["cg_exit"] += 3
    guidance.reset_host_read_counts()
    assert guidance.host_read_counts == {"cg_residual": 0, "cg_exit": 0,
                                         "iso_mean": 0}
