"""The PyTorch port (`kdip_tpu_torch`) against `kdip_tpu`: shared helpers of
the test_torch_* files, the port's import hygiene, and the measurement
operators.

Inputs are made with numpy from a seed and go through both packages; JAX's
NHWC arrays and the port's NCHW tensors meet only through `nchw`/`nhwc`.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu import operators as jops
from kdip_tpu_torch import operators as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a few layers at narrow width: two levels, one attention block (at 8 px),
# 32/64 channels so that GroupNorm(32) applies, 4 heads of 16 channels
SMALL_UNET = dict(image_size=16, in_channels=3, model_channels=32,
                  out_channels=6, num_res_blocks=1, attention_resolutions=(2,),
                  channel_mult=(1, 2), num_heads=4, num_head_channels=16)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Runs a module's small CPU ops on one torch thread: under the suite's
    parallel workers, torch's per-op thread pools oversubscribe the cores
    and spin, and tiny ops slow down a hundredfold. A module takes it with
    `pytestmark = pytest.mark.usefixtures("one_torch_thread")` and the
    import."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a) -> torch.Tensor:
    """kdip_tpu's NHWC array -> the port's NCHW float tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    """The port's NCHW tensor -> an NHWC float32 numpy array."""
    return np.ascontiguousarray(
        t.detach().cpu().to(torch.float32).numpy().transpose(0, 2, 3, 1))


def random_flax_params(init_fn, *init_args, seed: int = 0, std: float = 0.05):
    """A flax param tree of init_fn's structure with every leaf drawn from
    a seeded numpy generator, zero-initialised layers included (else eps is
    identically 0): GroupNorm scales 1 + std*N(0,1), everything else
    std*N(0,1). Only shapes are traced, nothing is compiled."""
    shapes = jax.eval_shape(init_fn, jax.random.key(0), *init_args)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        v = std * rng.standard_normal(s.shape).astype(np.float32)
        if any(getattr(k, "key", None) == "scale" for k in path):
            v += 1.0
        return v
    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

_IMPORT_CHECK = """
import pkgutil, sys, importlib
import kdip_tpu_torch
for m in pkgutil.walk_packages(kdip_tpu_torch.__path__, "kdip_tpu_torch."):
    importlib.import_module(m.name)
import bench_torch, chip_smoke
bad = sorted(n for n in sys.modules
             if n in ("jax", "flax", "kdip_tpu")
             or n.split(".")[0] in ("jax", "jaxlib", "flax", "kdip_tpu"))
print("loaded:", bad)
assert not bad, bad
print("import-clean", len([n for n in sys.modules
                           if n.startswith("kdip_tpu_torch")]))
"""


def test_port_imports_no_jax_and_no_kdip_tpu():
    """Every kdip_tpu_torch module, bench_torch.py and chip_smoke.py import
    without loading jax, flax or any kdip_tpu module (kdip_tpu_torch's own
    names start with "kdip_tpu", so names are compared exactly, by their
    first component)."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "import-clean" in r.stdout


def _port_sources():
    pkg = os.path.join(REPO, "kdip_tpu_torch")
    for d, _, files in os.walk(pkg):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "bench_torch.py")
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_yaml_jax_or_kdip_tpu():
    """No import statement anywhere in the port's sources, bench_torch.py
    or chip_smoke.py, at any depth, names yaml (the card's machine may lack
    PyYAML; config.load_yaml reads the subset), jax, flax or kdip_tpu.
    (Here torch itself loads yaml, so sys.modules cannot tell.)"""
    import ast
    banned = {"yaml", "jax", "jaxlib", "flax", "kdip_tpu"}
    found = []
    sources = list(_port_sources())
    assert {os.path.join(REPO, "kdip_tpu_torch", *p) for p in (
        ("models", "kdiff.py"), ("script_util.py",), ("train.py",),
        ("utils.py",), ("tfevents.py",), ("cli", "train_openai.py"),
        ("cli", "analytic_variance.py"), ("evaluation.py",),
        ("profiling.py",), ("models", "inception.py"),
        ("cli", "evaluate.py"), ("parallel", "dist.py"),
        ("parallel", "sharding.py"), ("ops", "tiling.py"),
        ("ops", "inpaint.py"), ("ops", "deblur.py"),
        ("ops", "image_utils.py"), ("ops", "dps_tools.py"),
        ("ops", "conv_mxu.py"))} <= set(sources)
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(os.path.relpath(path, REPO), n) for n in names
                      if n.split(".")[0] in banned]
    assert not found, found


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", [
    dict(mask_type="random", mask_prob_range=(0.5, 0.5), image_size=32),
    dict(mask_type="box", mask_len_range=(8, 16), image_size=32),
    dict(mask_type="extreme", mask_len_range=(8, 16), image_size=32),
])
def test_generate_mask_bit_exact(opt):
    for seed in (0, 7):
        np.testing.assert_array_equal(tops.generate_mask(seed=seed, **opt),
                                      jops.generate_mask(seed=seed, **opt))


def test_inpainting_operator_matches():
    """The p=0.5 inpainting config: the same mask, forward, transpose, and
    measurement with the noise injected (exact: masking and one fused
    multiply-add in float32)."""
    cfg = dict(name="inpainting", sigma_s=0.05,
               mask_opt=dict(mask_type="random", mask_prob_range=(0.5, 0.5),
                             image_size=16))
    jop = jops.get_operator(seed=3, **cfg)
    top = tops.get_operator(seed=3, device="cpu", **cfg)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    n = rng.standard_normal(x.shape).astype(np.float32)
    np.testing.assert_array_equal(nhwc(top.mask), np.asarray(jop.mask)[None])
    np.testing.assert_array_equal(nhwc(top.forward(nchw(x))),
                                  np.asarray(jop.forward(jnp.asarray(x))))
    np.testing.assert_array_equal(nhwc(top.transpose(nchw(x))),
                                  np.asarray(jop.transpose(jnp.asarray(x))))
    # kdip_tpu draws its noise from a key; feed the same draw to both
    key = jax.random.key(5)
    jn = np.asarray(jax.random.normal(key, x.shape))
    y_j = np.asarray(jop.measure(jnp.asarray(x), key).y)
    y_t = nhwc(top.measure(nchw(x), noise=nchw(jn)).y)
    np.testing.assert_allclose(y_t, y_j, atol=1e-7)


@pytest.mark.parametrize("name", ["phase_retrieval", "nonlinear_blur"])
def test_unported_operators_raise(name):
    """The nonlinear operators are ported (tests/test_torch_nonlinear.py),
    but they have no mat solver, in kdip_tpu as in the reference: a solve
    through one raises; the linear ones are held to kdip_tpu in
    test_torch_operators_blur_sr.py."""
    kw = {"blur_apply": lambda x01, kernel: x01,
          "kernel_shape": (1, 4, 2, 2)} if name == "nonlinear_blur" else {}
    op = tops.get_operator(name, device="cpu", **kw)
    assert op.name == name
    from kdip_tpu_torch import guidance as tg
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(NotImplementedError, match="no mat solver"):
        tg.mat_solver(op, op.forward(x), x, 0.5, None, True,
                      tg.GuidanceConfig())


def test_gaussian_noise_injected():
    x = torch.zeros(1, 3, 4, 4)
    n = torch.ones_like(x)
    assert torch.equal(tops.get_noise("gaussian", sigma=0.1)(x, noise=n),
                       x + 0.1)
    assert torch.equal(tops.get_noise("clean")(x), x)
