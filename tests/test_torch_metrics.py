"""The port's per-image metrics (`kdip_tpu_torch.metrics`) against
`kdip_tpu.metrics` on the same inputs, made with numpy from a seed, at 32
and 64 px: PSNR, the float32 and float64 SSIM, LPIPS-VGG on seeded random
VGG16 weights carried over by `weights.lpips_from_jax_params`, and the
aggregation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu import metrics as jm
from kdip_tpu_torch import metrics as tm
from kdip_tpu_torch import weights as tw
from test_torch_port import nchw


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Runs this file's small CPU ops on one thread: under the suite's
    parallel workers, torch's per-op thread pools oversubscribe the cores
    and tiny ops slow down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_lpips_params(seed: int = 0):
    """kdip_tpu's LPIPS-VGG tree with seeded random weights: He-scaled HWIO
    conv kernels (activations keep their scale through the 13 convs), small
    biases, non-negative lin weights."""
    rng = np.random.RandomState(seed)
    params, c_in, i = {}, 3, 0
    for c in jm._VGG16_CFG:
        if c == "M":
            continue
        params[f"conv{i}"] = {
            "kernel": (rng.standard_normal((3, 3, c_in, c))
                       * np.sqrt(2.0 / (9 * c_in))).astype(np.float32),
            "bias": (0.01 * rng.standard_normal(c)).astype(np.float32)}
        c_in, i = c, i + 1
    for j, c in enumerate((64, 128, 256, 512, 512)):
        params[f"lin{j}"] = {"kernel": np.abs(
            0.1 * rng.standard_normal(c)).astype(np.float32)}
    return params


def _pair(size: int, seed: int):
    """Two [2, size, size, 3] images in [0, 1]: one, and a noisy copy."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("size", [32, 64])
def test_psnr_and_ssim_match(size):
    """psnr within 1e-4 dB, ssim_f64 within 1e-12 (the same float64 code
    on the same layout; measured 4e-16), the float32 ssim within 1e-5
    (measured 7e-7)."""
    a, b = _pair(size, seed=size)
    ta, tb = nchw(a), nchw(b)
    np.testing.assert_allclose(tm.psnr(ta, tb).numpy(),
                               np.asarray(jm.psnr(jnp.asarray(a),
                                                  jnp.asarray(b))),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.ssim_f64(ta, tb), jm.ssim_f64(a, b),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.ssim(ta, tb).numpy(),
                               np.asarray(jm.ssim(jnp.asarray(a),
                                                  jnp.asarray(b))),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm.to_eval(nchw(2 * a - 1.5)).numpy(),
                                  np.asarray(jm.to_eval(
                                      jnp.asarray(2 * a - 1.5))
                                             ).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("size", [32, 64])
def test_lpips_vgg_matches(size):
    """Within 1e-5 relative: the same float32 VGG16 torso, taps, shift and
    scale, unit normalisation and lin weights (measured 1.8e-7)."""
    params = random_lpips_params(seed=1)
    tparams = tw.lpips_from_jax_params(params)
    a, b = _pair(size, seed=size + 1)
    want = np.asarray(jm.lpips_vgg(params, jnp.asarray(a), jnp.asarray(b)))
    got = tm.lpips_vgg(tparams, nchw(a), nchw(b)).numpy()
    assert want.shape == got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_lpips_weights_from_nested_and_flat_trees():
    """The nested tree and convert_weights' flat names give the same
    tensors: kernels HWIO -> OIHW, biases and lin weights as they are."""
    params = random_lpips_params(seed=2)
    flat = {f"{m}.{k}": v for m, sub in params.items() for k, v in sub.items()}
    a, b = tw.lpips_from_jax_params(params), tw.lpips_from_jax_params(flat)
    assert a.keys() == b.keys() and len(a) == 13 * 2 + 5
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
    np.testing.assert_array_equal(
        a["conv3.weight"].numpy(),
        params["conv3"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(a["lin4.weight"].numpy(),
                                  params["lin4"]["kernel"])
    with pytest.raises(KeyError):
        tw.lpips_from_jax_params({"conv0": {"scale": np.ones(3)}})


def test_compute_metrics_and_average_match():
    """compute_metrics on [-1,1] images reports batch element 0 in both
    packages; calculate_average_metric is the same sum and count."""
    params = random_lpips_params(seed=3)
    tparams = tw.lpips_from_jax_params(params)
    a, b = _pair(32, seed=5)
    x0, hat = 2 * a - 1, 2 * b - 1
    want = jm.compute_metrics(jnp.asarray(hat), jnp.asarray(x0), params)
    got = tm.compute_metrics(nchw(hat), nchw(x0), tparams)
    assert got.keys() == want.keys() == {"psnr", "ssim", "lpips"}
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert abs(got["ssim"] - want["ssim"]) <= 1e-12
    assert abs(got["lpips"] - want["lpips"]) <= 1e-5 * want["lpips"]
    assert tm.compute_metrics(nchw(hat), nchw(x0)).keys() == {"psnr", "ssim"}
    rows = [want, {"psnr": 3.0, "ssim": 0.5}, {"psnr": 1.25}]
    assert tm.calculate_average_metric(rows) == \
        jm.calculate_average_metric(rows)
