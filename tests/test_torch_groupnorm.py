"""`ops.groupnorm` on the CPU: the plain versions that the GroupNorm kernels
(csrc/groupnorm_silu.cu) are held to on the card, and the sites of the ADM
torso that run them. Imports no JAX.

- The plain forward is the eager composition GroupNorm32 and the ResBlock
  ran before the kernels (written out below as `composition`): equal bit
  for bit, since it computes the same ops in the same order. On the CPU
  `group_norm` and `affine_terms` run it under autograd, so a CPU run's
  outputs and gradients are the composition's, bit for bit.
- The closed-form backward (`group_norm_backward_plain`,
  `affine_terms_backward_plain`, `param_grads`: what the kernels compute
  on the card) against autograd of that composition. In
  float64 the two are the same function of the same numbers, so they agree
  to rounding (rtol 1e-9 of the largest gradient). In float32 (rtol 1e-5):
  both are float32 throughout and differ only in the order of their sums,
  each within a few float32 ulps of the largest term. In bfloat16 autograd
  rounds every intermediate of its backward to bfloat16 while the closed
  form keeps float32 inside and rounds once, so both are held to the
  float64 gradient of the same function at the same rounded points
  instead: the closed form within 2^-7 of the largest gradient (one
  bfloat16 rounding of the result, the inputs' roundings shared), and no
  further from it than the eager bfloat16 chain.
- The sites: one forward call a GroupNorm32 of the FFHQ-256 UNet (65, all
  full) and of the ImageNet-256 UNet on the Winograd kernels (79 of the
  statistics alone, 22 full), by a forward on the meta device.
"""

import pytest
import torch
import torch.nn.functional as F

from kdip_tpu_torch import weights
from kdip_tpu_torch.models import adm, layers
from kdip_tpu_torch.ops import groupnorm as gn

G, EPS = 32, 1e-5
SHAPES = {2: (3, 2048), 3: (2, 64, 37), 4: (2, 64, 6, 10)}


def _acc(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def composition(x, w, b, scale=None, shift=None, silu=False):
    """GroupNorm32.forward, then the ResBlock's `* (1 + scale) + shift` and
    nn.SiLU, as eager ops (float64 throughout for a float64 x)."""
    B, C = x.shape[:2]
    acc = _acc(x.dtype)
    x32 = x.to(acc).reshape(B, G, -1)
    m = x32.mean(dim=-1)
    m2 = x32.square().mean(dim=-1)
    rstd = torch.rsqrt((m2 - m.square()).clamp(min=0.0) + EPS)
    a = rstd[:, :, None] * w.reshape(G, C // G)[None]
    bb = b.reshape(G, C // G)[None] - m[:, :, None] * a
    a, bb = a.reshape(B, C), bb.reshape(B, C)
    shape = a.shape + (1,) * (x.ndim - 2)
    y = (x.to(acc) * a.reshape(shape) + bb.reshape(shape)).to(x.dtype)
    if scale is not None:
        y = y * (1 + scale.reshape(shape)) + shift.reshape(shape)
    if silu:
        y = F.silu(y)
    return y, (a, bb)


def inputs(ndim, dtype, film, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = SHAPES[ndim]
    B, C = shape[:2]
    x = (1.5 * torch.randn(shape, generator=g, dtype=torch.float64)
         + 0.3).to(dtype)
    pdt = _acc(dtype)
    w = (1 + 0.3 * torch.randn(C, generator=g, dtype=torch.float64)).to(pdt)
    b = (0.3 * torch.randn(C, generator=g, dtype=torch.float64)).to(pdt)
    st = None
    if film:
        st = tuple((0.3 * torch.randn(B, C, generator=g, dtype=torch.float64)
                    ).to(dtype) for _ in range(2))
    gy = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    return x, w, b, st, gy


def grads(fn, x, w, b, st, gy):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, w, b) + (st or ())]
    y = fn(*leaves)
    return y, torch.autograd.grad(y, leaves, gy)


def statistics(x):
    """[B, G, 2] (mean, raw variance), in the closed form's working type."""
    x32 = x.to(_acc(x.dtype)).reshape(x.shape[0], G, -1)
    m = x32.mean(dim=-1)
    return torch.stack([m, x32.square().mean(dim=-1) - m.square()], -1)


def closed_form(x, w, b, st, gy, silu):
    """gx, gamma's, beta's and the FiLM terms' gradients by the closed-form
    backward (`group_norm_backward_plain`, `param_grads`)."""
    s, t = st or (None, None)
    stats = statistics(x)
    gx, sums = gn.group_norm_backward_plain(x, gy, w, b, stats, G, EPS, s,
                                            t, silu)
    out = (gx,) + gn.param_grads(sums[0], sums[1], stats, EPS)
    if st:
        out += (sums[3].to(s.dtype), sums[2].to(t.dtype))
    return out


def composition_grads(x, w, b, st, gy, silu):
    return grads(lambda *a: composition(*a, silu=silu)[0], x, w, b, st,
                 gy)[1]


CASES = [(film, silu) for film in (False, True) for silu in (False, True)]
NAMES = ("x", "gamma", "beta", "scale", "shift")


@pytest.mark.parametrize("ndim", (2, 3, 4))
@pytest.mark.parametrize("film,silu", CASES)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_plain_forward_is_the_composition(dtype, film, silu, ndim):
    x, w, b, st, _ = inputs(ndim, dtype, film)
    y, stats = gn.group_norm_plain(x, w, b, G, EPS, *(st or (None, None)),
                                   silu=silu)
    assert y.dtype == x.dtype
    assert torch.equal(y, composition(x, w, b, *(st or ()), silu=silu)[0])
    a, bb, stats2 = gn.affine_terms_plain(x, w, b, G, EPS)
    a0, b0 = composition(x, w, b)[1]
    assert torch.equal(a, a0) and torch.equal(bb, b0)
    assert torch.equal(stats, stats2)


@pytest.mark.parametrize("ndim", (2, 3, 4))
@pytest.mark.parametrize("film,silu", CASES)
@pytest.mark.parametrize("dtype,rtol", ((torch.float64, 1e-9),
                                        (torch.float32, 1e-5)))
def test_backward_matches_autograd(dtype, rtol, film, silu, ndim):
    x, w, b, st, gy = inputs(ndim, dtype, film, seed=1)
    got = closed_form(x, w, b, st, gy, silu)
    want = composition_grads(x, w, b, st, gy, silu)
    assert len(got) == len(want)
    for name, g1, g0 in zip(NAMES, got, want):
        assert g1.dtype == g0.dtype, name
        err = (g1.double() - g0.double()).abs().max()
        assert err <= rtol * g0.double().abs().max(), (name, float(err))


@pytest.mark.parametrize("ndim", (2, 3, 4))
@pytest.mark.parametrize("film,silu", CASES)
def test_backward_bf16_against_float64(film, silu, ndim):
    x, w, b, st, gy = inputs(ndim, torch.bfloat16, film, seed=2)
    got = closed_form(x, w, b, st, gy, silu)
    eager = composition_grads(x, w, b, st, gy, silu)
    up = tuple(t.double() for t in st) if st else None
    truth = composition_grads(x.double(), w.double(), b.double(), up,
                              gy.double(), silu)
    for name, g1, g0, g64 in zip(NAMES, got, eager, truth):
        assert g1.dtype == g0.dtype, name
        scale = g64.abs().max()
        err = (g1.double() - g64).abs().max()
        eager_err = (g0.double() - g64).abs().max()
        assert err <= 2 ** -7 * scale, (name, float(err / scale))
        assert err <= eager_err + 2 ** -8 * scale, (name, float(err),
                                                    float(eager_err))


@pytest.mark.parametrize("ndim", (2, 3, 4))
@pytest.mark.parametrize("dtype,rtol", ((torch.float64, 1e-9),
                                        (torch.float32, 1e-5),
                                        (torch.bfloat16, 2 ** -7)))
def test_affine_terms_backward(dtype, rtol, ndim):
    """The statistics' backward, gx = c1*x + c2 (bfloat16 x: float32
    inside, rounded once, against float64 autograd at the same x)."""
    x, w, b, _, _ = inputs(ndim, dtype, False, seed=3)
    g = torch.Generator().manual_seed(4)
    ga, gb = (torch.randn(x.shape[:2], generator=g, dtype=torch.float64).to(
        _acc(dtype)) for _ in range(2))
    stats = statistics(x)
    got = (gn.affine_terms_backward_plain(x, ga, gb, w, stats, G, EPS),
           ) + gn.param_grads(ga, gb, stats, EPS)

    def old(x, w, b):
        a, bb = composition(x, w, b)[1]
        return (a * ga.to(a.dtype) + bb * gb.to(a.dtype)).sum()
    up = (x, w, b) if dtype != torch.bfloat16 else tuple(
        t.double() for t in (x, w, b))
    want = grads(old, *up, None, torch.ones((), dtype=up[1].dtype))[1]
    for name, g1, g0 in zip(NAMES, got, want):
        err = (g1.double() - g0.double()).abs().max()
        assert err <= rtol * g0.double().abs().max(), (name, float(err))


@pytest.mark.parametrize("film,silu", CASES)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_cpu_route_is_the_eager_composition(dtype, film, silu):
    """On the CPU `group_norm` and `affine_terms` run the plain forward and
    autograd differentiates it: outputs and every gradient equal the eager
    composition's bit for bit, as before the kernels."""
    x, w, b, st, gy = inputs(4, dtype, film, seed=6)
    y1, g1 = grads(lambda *a: gn.group_norm(*a[:3], G, EPS, *a[3:],
                                            silu=silu), x, w, b, st, gy)
    y0, g0 = grads(lambda *a: composition(*a, silu=silu)[0], x, w, b, st,
                   gy)
    assert torch.equal(y1, y0)
    assert all(torch.equal(p, q) for p, q in zip(g1, g0))
    _, ga = grads(lambda *a: sum(gn.affine_terms(*a, G, EPS)).sum(), x, w,
                  b, None, torch.ones(()))
    _, ga0 = grads(lambda *a: sum(composition(*a)[1]).sum(), x, w, b, None,
                   torch.ones(()))
    assert all(torch.equal(p, q) for p, q in zip(ga, ga0))


def test_film_needs_both_terms():
    x, w, b, st, _ = inputs(4, torch.float32, True)
    with pytest.raises(ValueError, match="both"):
        gn.group_norm(x, w, b, G, EPS, st[0], None)


def test_plans_cover_both_cache_paths():
    """The kernel's two ways through pass two, at the cells' 256 px
    shapes: the whole range cached (the forward at 128 channels, the
    backward at 128), and part of it read again (the backward at 256
    channels, 2 MB a slab)."""
    fwd = gn.launch_plan(8, 128, G, 256 * 256, 2, "fwd")
    assert fwd.cluster == 8 and fwd.cap == 4 * fwd.span // fwd.vec
    bwd = gn.launch_plan(8, 128, G, 256 * 256, 2, "bwd")
    assert bwd.cluster == 8 and bwd.cap == 4 * bwd.span // bwd.vec
    wide = gn.launch_plan(8, 256, G, 256 * 256, 2, "bwd")
    assert wide.cluster == 8 and 0 < wide.cap < 8 * wide.span // wide.vec
    # a [B, 2048] head: one position a channel, no 16-byte packs
    head = gn.launch_plan(3, 2048, G, 1, 2, "fwd")
    assert head.vec == 1 and head.cluster == 1 and head.span == 1
    stats = gn.launch_plan(2, 256, G, 256 * 256, 2, "stats")
    assert stats.cap == 0 and stats.cluster == 8
    for kind, p in (("fwd", fwd), ("bwd", bwd), ("bwd", wide),
                    ("fwd", head)):
        assert p.threads % 32 == 0 and p.threads <= gn.MAX_THREADS[kind]
        assert p.cap * p.vec * gn.cached_bytes(kind, 2) <= 200 * 1024


def test_cuda_wrappers_refuse_cpu_tensors():
    x, w, b, _, _ = inputs(4, torch.bfloat16, False)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_cuda(x, w, b, G, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        gn.affine_terms_cuda(x, w, b, G, EPS)


def _site_counts(monkeypatch, build, B, winograd):
    counts = {"full": 0, "stats": 0}
    full_fn, stats_fn = gn.group_norm, gn.affine_terms

    def count_full(*a, **k):
        counts["full"] += 1
        return full_fn(*a, **k)

    def count_stats(*a, **k):
        counts["stats"] += 1
        return stats_fn(*a, **k)
    monkeypatch.setattr(gn, "group_norm", count_full)
    monkeypatch.setattr(gn, "affine_terms", count_stats)
    with torch.device("meta"):
        model = build(device="meta", winograd=winograd)
    weights.precast_inference(model)
    n_modules = sum(isinstance(m, layers.GroupNorm32)
                    for m in model.modules())
    model(torch.empty(B, 3, 256, 256, device="meta"),
          torch.empty(B, device="meta"))
    return counts, n_modules


@pytest.mark.parametrize("name,build,B,winograd,want", (
    ("ffhq", adm.ffhq_unet, 8, False, {"full": 65, "stats": 0}),
    ("imagenet", adm.imagenet_unet, 2, True, {"full": 22, "stats": 79})))
def test_site_counts(monkeypatch, name, build, B, winograd, want):
    counts, n_modules = _site_counts(monkeypatch, build, B, winograd)
    assert counts == want
    assert n_modules == want["full"] + want["stats"]
