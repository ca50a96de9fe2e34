"""The fused covariance matvec of DWT-Var (`kdip_tpu_torch.ops.dwt.ot_matvec`,
`OrthoTransform.masked_cov_matvec`) on the CPU path, against `kdip_tpu`'s
composition in its CG matvec (guidance.py:394-395), with the jnp butterflies
and with the Pallas kernel in interpret mode; and the launch choice
(`launch_config`) and argument checks of its CUDA kernel, which need no
card. The kernel itself is held against its plain version on the card
(test_torch_dwt_cuda.py, chip_smoke.py)."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu.ops import transforms as jtf
from kdip_tpu_torch.ops import _build
from kdip_tpu_torch.ops import dwt as D
from kdip_tpu_torch.ops import transforms as T
from test_torch_port import nchw, nhwc

S2 = float(np.float32(0.05) ** 2)  # the inpainting solve's sigma_s^2


def _inputs(shape, seed):
    """NHWC v ~ N(0, 1), theta in [0.5, 1.5) of v's shape, and a 0/1 mask
    of one sample, from a numpy seed."""
    rng = np.random.RandomState(seed)
    v = rng.standard_normal(shape).astype(np.float32)
    theta = (0.5 + rng.random_sample(shape)).astype(np.float32)
    mask = (rng.random_sample((1,) + shape[1:]) < 0.5).astype(np.float32)
    return v, theta, mask


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (2, 16, 24, 2)],
                         ids=["square", "non-square"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_ot_matvec_matches_kdip_tpu(level, shape, pallas):
    """s2 * v + mask * iot(theta * ot(v)) as kdip_tpu's CG matvec composes
    it, with OrthoTransform("dwt") on the jnp butterflies or on the Pallas
    kernel (interpret mode on the CPU); and without the mask, its
    ot_covariance. atol 2e-6, as test_torch_dwt.py holds the transforms."""
    v, theta, mask = _inputs(shape, 10 * level + len(shape))
    ot = jtf.OrthoTransform("dwt", level=level, use_pallas=pallas)
    vj, tj, mj = (jnp.asarray(a) for a in (v, theta, mask))
    want = S2 * vj + mj * ot.inv(tj * ot(vj))
    got = D.ot_matvec(nchw(v), nchw(theta), nchw(mask), S2, level)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-6)
    cov = jtf.ot_covariance(ot, tj)(vj)
    got = D.ot_matvec(nchw(v), nchw(theta), level=level)
    np.testing.assert_allclose(nhwc(got), np.asarray(cov), atol=2e-6)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("level", [4, 5])
def test_chained_ot_matvec_matches_kdip_tpu(level, pallas):
    """ot_matvec past the kernel's single-pass levels, on the CPU path,
    against kdip_tpu's CG matvec and ot_covariance with
    OrthoTransform("dwt", level), atol 2e-6 as above."""
    v, theta, mask = _inputs((2, 32, 64, 3), 50 + level)
    ot = jtf.OrthoTransform("dwt", level=level, use_pallas=pallas)
    vj, tj, mj = (jnp.asarray(a) for a in (v, theta, mask))
    want = S2 * vj + mj * ot.inv(tj * ot(vj))
    got = D.ot_matvec(nchw(v), nchw(theta), nchw(mask), S2, level)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-6)
    cov = jtf.ot_covariance(ot, tj)(vj)
    got = T.ot_covariance(T.OrthoTransform("dwt", level), nchw(theta))(
        nchw(v))
    np.testing.assert_allclose(nhwc(got), np.asarray(cov), atol=2e-6)


@pytest.mark.parametrize("level", [4, 5, 8])
def test_chained_matvec_equals_plain(monkeypatch, level):
    """The card's matvec past MAX_LEVEL (the chained passes around theta,
    then s2 * v + mask * w), run with the kernel's plain version in its
    place: bit-equal to ot_matvec_plain, with and without the mask, theta
    and the mask per sample and repeating over the batch."""
    def stand_in(x, lv, inverse):
        assert x.is_contiguous() and lv <= D.MAX_LEVEL
        return (D.idwt2_plain if inverse else D.dwt2_plain)(x, lv)
    monkeypatch.setattr(D, "haar_dwt2_cuda", stand_in)
    v, theta, mask = (nchw(a) for a in _inputs((2, 256, 256, 3), level))
    for th, m in ((theta, mask), (theta[:1], mask[:1]), (theta, None)):
        s2 = 0.0 if m is None else S2
        assert torch.equal(D._chained_matvec(v, th, m, s2, level),
                           D.ot_matvec_plain(v, th, m, s2, level))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_ot_matvec_plain_is_the_composition(level):
    """ot_matvec_plain, and masked_cov_matvec on both transforms, equal the
    port's composed ops (what the CG's matvec ran before) bit for bit: with
    and without the mask, theta per sample and repeating over the batch."""
    v, theta, mask = (nchw(a) for a in _inputs((3, 16, 24, 2), level))
    ot = T.OrthoTransform("dwt", level=level)
    for th in (theta, theta[:1]):
        composed = S2 * v + mask * ot.inv(th * ot(v))
        assert torch.equal(D.ot_matvec_plain(v, th, mask, S2, level), composed)
        assert torch.equal(ot.masked_cov_matvec(v, th, mask, S2), composed)
        assert torch.equal(D.ot_matvec_plain(v, th, level=level),
                           ot.inv(th * ot(v)))
        assert torch.equal(T.ot_covariance(ot, th)(v), ot.inv(ot(v) * th))
    ident = T.OrthoTransform(None)
    assert torch.equal(ident.masked_cov_matvec(v, theta, mask, S2),
                       S2 * v + mask * ident.inv(theta * ident(v)))


def _covered_once(cfg, planes, H, W, level):
    """Each position of every plane lies in the 2 x vec patch of exactly one
    thread of the launch, as the kernel's patch_of maps a thread to its
    patch; the lanes that share a tile lie in one warp; the lanes past the
    last patch are the end of the last warp."""
    U, S = cfg.vec, 1 << level
    SG = max(U, S)                       # a group of tiles, LPG lanes
    CU = SG // U
    LPG = S // 2 * CU
    assert 32 % LPG == 0
    t = np.arange(D.launch_shape(cfg, planes, H, W) * cfg.threads)
    rp, cu = (t % LPG) // CU, (t % LPG) % CU
    group = t // LPG
    per_row = W // SG
    per_plane = H // S * per_row
    active = group < planes * per_plane
    assert active.sum() == planes * H * W // (2 * U)
    assert not active[-1] or len(t) == active.sum()
    assert len(t) - active.sum() < cfg.threads
    plane, gi = np.divmod(group[active], per_plane)
    y0 = gi // per_row * S + 2 * rp[active]
    x0 = gi % per_row * SG + cu[active] * U
    hits = np.zeros((planes, H, W), np.int32)
    for dy in (0, 1):
        for dx in range(U):
            np.add.at(hits, (plane, y0 + dy, x0 + dx), 1)
    return bool((hits == 1).all())


def _check_launch(planes, H, W, level, vec=4):
    cfg = D.launch_config(planes, H, W, vec)
    assert cfg.vec == (4 if vec == 4 and W % 4 == 0 else 2)
    assert cfg.threads in D.THREADS
    assert _covered_once(cfg, planes, H, W, level)
    return cfg, D.launch_shape(cfg, planes, H, W)


def test_launch_config_covers_every_tile_once():
    """The slice's shapes (one sample and the batch of 4 at 256 px, levels
    1-3) and 100 random valid shapes: the threads' patches tile every plane
    exactly once; the slice's per-sample shape gets >= 132 CTAs (128
    threads, 192 CTAs)."""
    for planes in (3, 12):
        for level in (1, 2, 3):
            cfg, ctas = _check_launch(planes, 256, 256, level)
            assert ctas >= D.MIN_CTAS and cfg.vec == 4
    assert D.launch_config(3, 256, 256) == D.LaunchConfig(128, 4)
    rng = np.random.RandomState(0)
    for _ in range(100):
        level = int(rng.randint(1, 4))
        S = 1 << level
        H, W = (S * int(rng.randint(1, 40)) for _ in range(2))
        _check_launch(int(rng.randint(1, 13)), H, W, level,
                      int(rng.choice([2, 4])))


def test_matvec_wrapper_rejects_what_it_cannot_take():
    """The checks raise before any build or launch, on CPU tensors too:
    shapes, theta and mask broadcasts other than per sample or repeating
    over the batch, dtype, contiguity, level (the kernel: 1..3; ot_matvec:
    >= 1 with 2^level dividing H and W), s2 without a mask; then the
    device."""
    v, theta, mask = (nchw(a) for a in _inputs((2, 16, 16, 3), 0))
    bad = {
        "theta": (v, theta[:, :1], mask),
        "mask": (v, theta, mask[:, :1]),
        "neither": (v, torch.cat([theta, theta]), mask),
        "float32": (v.double(), theta, mask),
        "contiguous": (v.transpose(2, 3), theta, mask),
        "NCHW": (v[0], theta, mask),
    }
    for fn in (D.ot_matvec, D.haar_ot_matvec_cuda):
        for match, args in bad.items():
            with pytest.raises(ValueError, match=match):
                fn(*args, S2, 3)
        if fn is D.haar_ot_matvec_cuda:
            # the kernel's single pass takes levels 1..3
            with pytest.raises(ValueError, match="level"):
                fn(v, theta, mask, S2, 4)
        else:
            # ot_matvec chains passes past 3 but refuses level 0 and a
            # level whose 2^level does not divide H and W (16 x 16)
            with pytest.raises(ValueError, match="level"):
                fn(v, theta, mask, S2, 0)
            with pytest.raises(ValueError, match="divisible"):
                fn(v, theta, mask, S2, 5)
        with pytest.raises(ValueError, match="divisible"):
            fn(v[..., :12].contiguous(), theta[..., :12].contiguous(),
               mask[..., :12].contiguous(), S2, 3)
        with pytest.raises(ValueError, match="mask"):
            fn(v, theta, None, S2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        D.haar_ot_matvec_cuda(v, theta, mask, S2, 3)


def test_ctypes_prototypes_match_the_c_entry_points():
    """The argtypes the wrapper gives ctypes match the parameters of the C
    entry points in csrc/haar_dwt.cu, one by one: pointers as c_void_p,
    int64_t as c_int64, float as c_float, int as c_int."""
    src = (_build.CSRC / "haar_dwt.cu").read_text()
    kinds = {ctypes.c_void_p: "*", ctypes.c_int64: "int64_t",
             ctypes.c_float: "float", ctypes.c_int: "int"}
    for name, argtypes in D.ARGTYPES.items():
        params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                           src).group(1).split(",")
        assert len(params) == len(argtypes), name
        for param, t in zip(params, argtypes):
            want = kinds[t]
            got = ("*" if "*" in param else param.split()[-2])
            assert got == want, (name, param, want)
