"""The port's Haar DWT (`kdip_tpu_torch.ops.dwt`) against `kdip_tpu`'s Pallas
kernel (interpret mode on the CPU, as tests/test_pallas_dwt.py runs it) and
jnp butterflies, on the CPU path: the plain PyTorch version and the autograd
pair around it. The CUDA kernel itself is held against the plain version on
the card (test_torch_dwt_cuda.py, chip_smoke.py)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu.ops import transforms as jtf
from kdip_tpu.ops.pallas_dwt import dwt2_pallas, idwt2_pallas
from kdip_tpu_torch.ops import dwt as D
from kdip_tpu_torch.ops import transforms as T
from test_torch_port import REPO, nchw, nhwc

SHAPE = (2, 32, 32, 3)  # NHWC, as kdip_tpu takes it


def _x(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_plain_dwt_matches_pallas_and_jnp(level):
    """atol 2e-6, as test_pallas_dwt.py holds the Pallas kernel to the jnp
    butterflies: the kernel multiplies by packing matrices, the butterflies
    add and divide by sqrt 2, the port adds and multiplies by 1/sqrt 2."""
    x = _x(level)
    xj = jnp.asarray(x)
    fwd_p = np.asarray(dwt2_pallas(xj, level, interpret=True))
    inv_p = np.asarray(idwt2_pallas(xj, level, interpret=True))
    np.testing.assert_allclose(nhwc(D.dwt2(nchw(x), level)), fwd_p, atol=2e-6)
    np.testing.assert_allclose(nhwc(D.idwt2(nchw(x), level)), inv_p, atol=2e-6)
    np.testing.assert_allclose(nhwc(D.dwt2_plain(nchw(x), level)),
                               np.asarray(jtf.dwt2(xj, level=level)),
                               atol=2e-6)
    np.testing.assert_allclose(nhwc(D.idwt2_plain(nchw(x), level)),
                               np.asarray(jtf.idwt2(xj, level=level)),
                               atol=2e-6)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_round_trip_and_backward_match_jax_vjp(level):
    """idwt2(dwt2(x)) == x, and the autograd backward of each direction (the
    other direction) equals jax.vjp of the Pallas pair, atol 2e-6."""
    x, ct = _x(10 + level, (1, 64, 64, 3)), _x(20 + level, (1, 64, 64, 3))
    xt = nchw(x).requires_grad_(True)
    np.testing.assert_allclose(nhwc(D.idwt2(D.dwt2(xt, level), level)), x,
                               atol=2e-6)
    for fwd_t, fwd_j in ((D.dwt2, dwt2_pallas), (D.idwt2, idwt2_pallas)):
        g_t, = torch.autograd.grad(fwd_t(xt, level), xt,
                                   grad_outputs=nchw(ct))
        _, vjp = jax.vjp(lambda a: fwd_j(a, level, True), jnp.asarray(x))
        np.testing.assert_allclose(nhwc(g_t), np.asarray(vjp(jnp.asarray(ct))[0]),
                                   atol=2e-6)


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6])
def test_any_level_matches_kdip_tpu(level):
    """dwt2 / idwt2 at levels 1-6 (every level whose 2^level divides H and
    W) against kdip_tpu.ops.transforms.dwt2 / idwt2, atol 2e-6 as above,
    on a non-square plane; and the round trip."""
    x = _x(30 + level, (2, 64, 128, 3))
    xj = jnp.asarray(x)
    np.testing.assert_allclose(nhwc(D.dwt2(nchw(x), level)),
                               np.asarray(jtf.dwt2(xj, level=level)),
                               atol=2e-6)
    np.testing.assert_allclose(nhwc(D.idwt2(nchw(x), level)),
                               np.asarray(jtf.idwt2(xj, level=level)),
                               atol=2e-6)
    np.testing.assert_allclose(nhwc(D.idwt2(D.dwt2(nchw(x), level), level)),
                               x, atol=4e-6)


def _kernel_stand_in(calls):
    """haar_dwt2_cuda's checks and arithmetic on the CPU (its plain
    version), recording each pass's (shape, level, inverse)."""
    def run(x, level, inverse):
        assert x.is_contiguous() and 1 <= level <= D.MAX_LEVEL
        D.check_level(*x.shape[-2:], level, D.MAX_LEVEL)
        calls.append((tuple(x.shape[-2:]), level, inverse))
        return (D.idwt2_plain if inverse else D.dwt2_plain)(x, level)
    return run


@pytest.mark.parametrize("level", [1, 3, 4, 6, 7, 8])
def test_chained_passes_equal_plain(monkeypatch, level):
    """The card's chain of kernel passes (levels 1-3 on the plane, then up
    to 3 more on each approximation block, the inverse in reverse), run
    with the kernel's plain version in its place: bit-equal to
    dwt2_plain / idwt2_plain at [1, 3, 256, 256], the FFHQ plane."""
    calls = []
    monkeypatch.setattr(D, "haar_dwt2_cuda", _kernel_stand_in(calls))
    x = torch.randn(1, 3, 256, 256, generator=torch.Generator().manual_seed(
        level))
    assert torch.equal(D._chain(x, level, False), D.dwt2_plain(x, level))
    want = D.passes(level)
    assert calls == [((256 >> d, 256 >> d), n, False) for d, n in want]
    assert sum(n for _, n in want) == level
    calls.clear()
    assert torch.equal(D._chain(x, level, True), D.idwt2_plain(x, level))
    assert calls == [((256 >> d, 256 >> d), n, True)
                     for d, n in reversed(want)]


def test_levels_are_checked():
    """Level 0, and a level whose 2^level does not divide H and W, are
    refused (kdip_tpu's butterflies assert an even size at every level)."""
    x = torch.zeros(1, 3, 32, 48)
    for fn in (D.dwt2, D.idwt2):
        with pytest.raises(ValueError, match="level"):
            fn(x, 0)
        with pytest.raises(ValueError, match="divisible"):
            fn(x, 5)
        assert fn(x, 4).shape == x.shape


def test_non_square_and_dtype_preserved():
    x = torch.randn(1, 2, 16, 24, generator=torch.Generator().manual_seed(0))
    y = D.dwt2(x.to(torch.float64), 3)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(D.idwt2(y, 3).numpy(), x.numpy(), atol=1e-12)


def test_ortho_transform():
    x = nchw(_x(3, (1, 32, 32, 3)))
    ot = T.OrthoTransform("dwt")
    np.testing.assert_allclose(ot.inv(ot(x)).numpy(), x.numpy(), atol=2e-6)
    assert torch.equal(ot(x), D.dwt2(x, 3))
    ident = T.OrthoTransform(None)
    assert ident(x) is x and ident.inv(x) is x
    v = torch.rand_like(x)
    cov = T.ot_covariance(ot, v)
    jcov = jtf.ot_covariance(jtf.OrthoTransform("dwt"), jnp.asarray(nhwc(v)))
    np.testing.assert_allclose(nhwc(cov(x)), np.asarray(jcov(jnp.asarray(
        nhwc(x)))), atol=2e-6)
    with pytest.raises(ValueError):
        T.OrthoTransform("haar")


def test_kernel_wrapper_rejects_what_it_cannot_take():
    """The kernel wrapper takes CUDA tensors only; the checks that need no
    card (device, shape) raise before any build."""
    with pytest.raises(ValueError, match="CUDA"):
        D.haar_dwt2_cuda(torch.zeros(1, 3, 8, 8), 3, False)


_NO_NVCC = """
import kdip_tpu_torch.ops.dwt as D
import kdip_tpu_torch.ops._build as B, torch
assert D.launch_counts == {"haar_dwt2": 0, "haar_idwt2": 0,
                           "haar_ot_matvec": 0}
y = D.dwt2(torch.ones(1, 1, 8, 8), 3)  # the CPU path builds nothing
try:
    B.find_nvcc()
except RuntimeError as e:
    print("no-nvcc:", e)
print("import-ok", round(float(y[0, 0, 0, 0]), 4))
"""


def test_dwt_imports_without_nvcc():
    """`import kdip_tpu_torch.ops.dwt` and the CPU path work where there is
    no CUDA toolkit: nothing is built at import."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    r = subprocess.run([sys.executable, "-c", _NO_NVCC], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "import-ok 8.0" in r.stdout and "no-nvcc" in r.stdout
