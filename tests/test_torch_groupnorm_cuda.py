"""The GroupNorm kernels (kdip_tpu_torch/csrc/groupnorm_silu.cu) against their
plain PyTorch versions, on the card, at every GroupNorm shape of one guided
NFE of the benchmark's two cells (FFHQ-256 at B=8, bfloat16 torso with a
float32 head; ImageNet-256 at B=2 on the Winograd kernels), and the launch
counts of a full-width NFE. Imports no JAX:

    python -m pytest tests/test_torch_groupnorm_cuda.py -m cuda

Without a card every test skips.

Tolerances. Forward: both sides round the same values at the same places;
only the float32 summation order of the statistics differs (a few float32
ulps of the mean and the variance), which moves an output to the
neighbouring value of its type now and then, as do the kernel's fast exp
and division for a 16-bit result: at least 99.9% of outputs within one
bfloat16 ulp of the plain version's, and every output within 2^-6 of its
own size plus 2^-12 of the largest output.
(a, b) of the statistics alone: 1e-5 relative, the float32 statistics' own
agreement. Backward: float32 inside, rounded once, the per-channel sums and
the statistics' gradient in another order: every gx within one ulp of its
type of itself plus 2^-10 of the largest (the sums' float32 noise, carried
by c1*x + c2, which can cancel gu*a), and the per-channel sums within 1e-4
of the largest sum of their kind.
"""

import pytest
import torch

from kdip_tpu_torch import weights
from kdip_tpu_torch.models import adm
from kdip_tpu_torch.ops import groupnorm as gn

pytestmark = pytest.mark.cuda
G, EPS = 32, 1e-5
MANTISSA = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def nfe_sites(build, B, winograd):
    """[(form, shape, dtype, film, silu)] of one forward, from a forward on
    the meta device; form is "full" or "stats". Distinct entries only."""
    seen = []
    full_fn, stats_fn = gn.group_norm, gn.affine_terms

    def full(x, w, b, groups=32, eps=EPS, scale=None, shift=None,
             silu=False):
        seen.append(("full", tuple(x.shape), x.dtype, scale is not None,
                     silu))
        return full_fn(x, w, b, groups, eps, scale, shift, silu)

    def stats(x, w, b, groups=32, eps=EPS):
        seen.append(("stats", tuple(x.shape), x.dtype, False, False))
        return stats_fn(x, w, b, groups, eps)
    gn.group_norm, gn.affine_terms = full, stats
    try:
        with torch.device("meta"):
            model = build(device="meta", winograd=winograd)
        weights.precast_inference(model)
        model(torch.empty(B, 3, 256, 256, device="meta"),
              torch.empty(B, device="meta"))
    finally:
        gn.group_norm, gn.affine_terms = full_fn, stats_fn
    return sorted(set(seen), key=str)


SITES = {"ffhq_b8": (adm.ffhq_unet, 8, False),
         "imagenet_b2": (adm.imagenet_unet, 2, True)}


def site_list():
    out = []
    for cell, spec in SITES.items():
        for site in nfe_sites(*spec):
            out.append(pytest.param(site, id=f"{cell}-{site[0]}-"
                                    f"{'x'.join(map(str, site[1]))}-"
                                    f"{str(site[2])[6:]}-film{int(site[3])}"
                                    f"-silu{int(site[4])}"))
    return out


def make(card, shape, dtype, film, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    B, C = shape[:2]
    x = (1.5 * torch.randn(shape, generator=g, device=card) + 0.2).to(dtype)
    w = 1 + 0.3 * torch.randn(C, generator=g, device=card)
    b = 0.3 * torch.randn(C, generator=g, device=card)
    st = None
    if film:
        st = tuple((0.3 * torch.randn(B, C, generator=g, device=card)
                    ).to(dtype) for _ in range(2))
    gy = torch.randn(shape, generator=g, device=card).to(dtype)
    return x, w, b, st, gy


def ulp(g, w, dtype):
    """The spacing of dtype's values at the larger of |g| and |w|."""
    m = torch.maximum(g.abs(), w.abs()).clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(m)) - MANTISSA[dtype])


def check_forward(got, want):
    g, w = got.double(), want.double()
    d = (g - w).abs()
    within = d <= ulp(g, w, torch.bfloat16)
    assert within.double().mean() >= 0.999, float(within.double().mean())
    assert (d <= 2 ** -6 * w.abs() + 2 ** -12 * w.abs().max()).all(), \
        float(d.max())


def check_backward(got, want):
    g, w = got.double(), want.double()
    d = (g - w).abs()
    assert (d <= ulp(g, w, want.dtype) + 2 ** -10 * w.abs().max()).all(), \
        float((d / w.abs().max()).max())


@pytest.mark.parametrize("site", site_list())
def test_kernel_matches_plain_at_nfe_shapes(card, site):
    form, shape, dtype, film, silu = site
    x, w, b, st, gy = make(card, shape, dtype, film)
    s, t = st or (None, None)
    if form == "stats":
        a, bb, stats = gn.affine_terms_cuda(x, w, b, G, EPS)
        a0, b0, stats0 = gn.affine_terms_plain(x, w, b, G, EPS)
        for got, want in ((a, a0), (bb, b0), (stats[..., 0], stats0[..., 0])):
            assert torch.allclose(got, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max()))
        ga, gb = (torch.randn(a.shape, device=card) for _ in range(2))
        gx = gn.affine_terms_backward_cuda(x, ga, gb, w, stats, G, EPS)
        gx0 = gn.affine_terms_backward_plain(x, ga, gb, w, stats, G, EPS)
        check_backward(gx, gx0)
        return
    y, stats = gn.group_norm_cuda(x, w, b, G, EPS, s, t, silu)
    y0, stats0 = gn.group_norm_plain(x, w, b, G, EPS, s, t, silu)
    assert torch.allclose(stats, stats0, rtol=1e-5, atol=1e-6)
    check_forward(y, y0)
    gx, sums = gn.group_norm_backward_cuda(x, gy, w, b, stats, G, EPS, s, t,
                                           silu)
    gx0, sums0 = gn.group_norm_backward_plain(x, gy, w, b, stats, G, EPS, s,
                                              t, silu)
    check_backward(gx, gx0)
    for k in range(4):
        scale = float(sums0[k].abs().max()) or 1.0
        assert (sums[k] - sums0[k]).abs().max() <= 1e-4 * scale, k


def test_both_cache_paths_are_reached(card):
    """The 256 px sites run pass two from the cache whole (FFHQ at 128
    channels) and from the cache and device memory (the backward at 256
    channels, the float32 head): both are among the shapes above."""
    fwd = gn.launch_plan(8, 128, G, 256 * 256, 2, "fwd")
    bwd = gn.launch_plan(8, 256, G, 256 * 256, 2, "bwd")
    assert fwd.cap == 4 * fwd.span // fwd.vec
    assert 0 < bwd.cap < 8 * bwd.span // bwd.vec
    shapes = {s[1] for spec in SITES.values() for s in nfe_sites(*spec)}
    assert (8, 128, 256, 256) in shapes and (8, 256, 256, 256) in shapes


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16,
                                   torch.float32))
def test_dtypes_and_autograd(card, dtype):
    """Each dtype through the Functions, FiLM and SiLU on, against the plain
    versions on the same values: y, and the gradients of x, gamma, beta,
    scale and shift (the closed form and `param_grads`); (a, b) of the
    statistics alone and their x, gamma and beta gradients."""
    x, w, b, st, gy = make(card, (2, 96, 18, 22), dtype, True, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b) + st]
    y = gn.group_norm(*leaves[:3], G, EPS, *leaves[3:], silu=True)
    got = torch.autograd.grad(y, leaves, gy)
    y0, stats = gn.group_norm_plain(x, w, b, G, EPS, *st, silu=True)
    gx0, sums = gn.group_norm_backward_plain(x, gy, w, b, stats, G, EPS, *st,
                                             silu=True)
    want = (gx0,) + gn.param_grads(sums[0], sums[1], stats, EPS) + (
        sums[3].to(dtype), sums[2].to(dtype))
    check_forward(y, y0)
    check_backward(got[0], want[0])
    for g1, g0 in zip(got[1:], want[1:]):
        g1, g0 = g1.double(), g0.double()
        assert (g1 - g0).abs().max() <= 1e-3 * g0.abs().max() + 1e-6
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ga, gb = (torch.randn(2, 96, device=card) for _ in range(2))
    a, bb = gn.affine_terms(*leaves, G, EPS)
    got = torch.autograd.grad((a * ga + bb * gb).sum(), leaves)
    a0, b0, stats = gn.affine_terms_plain(x, w, b, G, EPS)
    want = (gn.affine_terms_backward_plain(x, ga, gb, w, stats, G, EPS),
            ) + gn.param_grads(ga, gb, stats, EPS)
    assert torch.allclose(a, a0, rtol=1e-5) and torch.allclose(
        bb, b0, rtol=1e-5, atol=1e-6)
    check_backward(got[0], want[0])
    for g1, g0 in zip(got[1:], want[1:]):
        assert (g1 - g0).abs().max() <= 1e-4 * g0.abs().max() + 1e-6


def test_film_gradients_each_by_its_own_flag(card):
    """Where only the shift, or only the scale, asks for a gradient, that
    one still gets its own (the Function returns each by its own flag)."""
    x, w, b, st, gy = make(card, (2, 64, 8, 8), torch.bfloat16, True, seed=5)
    _, stats = gn.group_norm_plain(x, w, b, G, EPS, *st, silu=True)
    _, sums = gn.group_norm_backward_plain(x, gy, w, b, stats, G, EPS, *st,
                                           silu=True)
    want = (sums[3].to(x.dtype), sums[2].to(x.dtype))
    for i in (0, 1):
        film = [t.clone() for t in st]
        film[i].requires_grad_(True)
        y = gn.group_norm(x, w, b, G, EPS, *film, silu=True)
        got, = torch.autograd.grad(y, film[i], gy)
        g1, g0 = got.double(), want[i].double()
        assert (g1 - g0).abs().max() <= 1e-3 * g0.abs().max() + 1e-6, i


def test_argument_checks(card):
    x, w, b, st, gy = make(card, (2, 64, 8, 8), torch.bfloat16, True)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        gn.group_norm_cuda(x.double(), w, b, G, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_cuda(x.transpose(2, 3), w, b, G, EPS)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_cuda(x[:, :48].contiguous(), w[:48], b[:48], G, EPS)
    with pytest.raises(ValueError, match="at most 64"):
        big = torch.zeros(1, 32 * 65, 2, device=card, dtype=torch.bfloat16)
        gn.group_norm_cuda(big, torch.ones(32 * 65, device=card),
                           torch.zeros(32 * 65, device=card), G, EPS)
    with pytest.raises(ValueError, match="float32"):
        gn.group_norm_cuda(x, w.to(torch.bfloat16), b, G, EPS)
    with pytest.raises(ValueError, match="FiLM"):
        gn.group_norm_cuda(x, w, b, G, EPS, st[0].float(), st[1].float())
    with pytest.raises(ValueError, match="both"):
        gn.group_norm_cuda(x, w, b, G, EPS, st[0], None)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_cuda(x.cpu(), w, b, G, EPS)
    _, stats = gn.group_norm_cuda(x, w, b, G, EPS)
    with pytest.raises(ValueError, match="incoming gradient"):
        gn.group_norm_backward_cuda(x, gy.float(), w, b, stats, G, EPS)
    with pytest.raises(ValueError, match="gradients of a and b"):
        gn.affine_terms_backward_cuda(x, gy, gy, w, stats, G, EPS)


@pytest.mark.parametrize("cell", sorted(SITES))
def test_launch_counts_of_a_full_width_nfe(card, cell):
    """One UNet forward and its vjp to x at the cell's batch: one forward
    launch a site (FFHQ 65; ImageNet 22 full + 79 of the statistics) and
    one backward launch a site."""
    build, B, winograd = SITES[cell]
    torch.manual_seed(0)
    with torch.device(card):
        model = build(device=card, winograd=winograd)
    weights.precast_inference(model)
    model.eval().requires_grad_(False)
    x = torch.randn(B, 3, 256, 256, device=card, requires_grad=True)
    t = torch.full((B,), 500.0, device=card)
    gn.reset_launch_counts()
    out = model(x, t)
    fwd = dict(gn.launch_counts)
    torch.autograd.grad(out, x, torch.randn_like(out))
    torch.cuda.synchronize()
    bwd = {k: gn.launch_counts[k] - fwd[k] for k in fwd}
    full, stats = (65, 0) if cell == "ffhq_b8" else (22, 79)
    assert fwd == {"groupnorm_fwd": full, "groupnorm_stats_fwd": stats,
                   "groupnorm_bwd": 0, "groupnorm_stats_bwd": 0}
    assert bwd == {"groupnorm_fwd": 0, "groupnorm_stats_fwd": 0,
                   "groupnorm_bwd": full, "groupnorm_stats_bwd": stats}
