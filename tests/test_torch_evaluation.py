"""The port's FID/KID (`kdip_tpu_torch.evaluation`) against
`kdip_tpu.evaluation`, on the CPU, in float32 as both run there.

Features are seeded numpy arrays at D=64: n=300 gives full-rank
covariances, n=40 rank-deficient ones, whose matrix square roots take the
square roots of eigenvalues that float32 leaves at ~1e-6 of the largest
(clipped at 0 where they come out negative), so the two packages' eigh
part further there: rtol 1e-4 for full rank, 1e-3 for rank deficient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu import evaluation as je
from kdip_tpu_torch import evaluation as te
from kdip_tpu_torch.utils import seeded_generator
from test_torch_port import nchw, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D = 64
RTOL = {300: 1e-4, 40: 1e-3}


def features(n: int, seed: int, shift: float = 0.0):
    """[n, D] float32 features with a decaying spectrum and a mean."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((D, D)) / (1 + np.arange(D))[:, None] ** 0.5
    return (rng.standard_normal((n, D)) @ mix + shift + 0.3).astype(
        np.float32)


@pytest.mark.parametrize("n", [300, 40])
def test_kernel_and_mmd_match(n):
    x, y = features(n, 1), features(n - 7, 2, shift=0.1)
    want = np.asarray(je.polynomial_kernel(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(
        te.polynomial_kernel(torch.from_numpy(x), torch.from_numpy(y)),
        want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(
        float(te.squared_mmd(torch.from_numpy(x), torch.from_numpy(y))),
        float(je.squared_mmd(jnp.asarray(x), jnp.asarray(y))), rtol=RTOL[n])


@pytest.mark.parametrize("max_size, parts", [(110, (83, 84, 83)),
                                             (80, (62, 63, 63, 62))])
def test_kid_partitions_match(max_size, parts):
    """300 against 250 features: 3 partitions of y of unequal length, and
    4 whose bounds 62.5 and 187.5 round to even (Python's round), as
    kdip_tpu cuts them."""
    x, y = features(300, 3), features(250, 4, shift=0.2)
    bounds = [round(i * 250 / len(parts)) for i in range(len(parts) + 1)]
    assert tuple(np.diff(bounds)) == parts
    got = float(te.kid(torch.from_numpy(x), torch.from_numpy(y), max_size))
    want = float(je.kid(jnp.asarray(x), jnp.asarray(y), max_size))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    by_hand = np.mean([float(te.squared_mmd(
        torch.from_numpy(x[round(i * 300 / len(parts)):
                           round((i + 1) * 300 / len(parts))]),
        torch.from_numpy(y[a:b])))
        for i, (a, b) in enumerate(zip(bounds, bounds[1:]))])
    np.testing.assert_allclose(got, by_hand, rtol=1e-6)


@pytest.mark.parametrize("n", [300, 40])
def test_sqrtm_and_fid_match(n):
    x, y = features(n, 5), features(n, 6, shift=0.1)
    cov = np.cov(x.T).astype(np.float32)
    root = te.sqrtm_eig(torch.from_numpy(cov)).numpy()
    want_root = np.asarray(je.sqrtm_eig(jnp.asarray(cov)))
    np.testing.assert_allclose(root, want_root, rtol=0,
                               atol=RTOL[n] * np.abs(want_root).max())
    if n == 300:
        np.testing.assert_allclose(root @ root, cov, rtol=0,
                                   atol=1e-4 * np.abs(cov).max())
    got = float(te.fid(torch.from_numpy(x), torch.from_numpy(y)))
    want = float(je.fid(jnp.asarray(x), jnp.asarray(y)))
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=RTOL[n])


def test_compute_features_matches_under_an_index_keyed_sample_fn():
    """With a sample_fn that makes batch i from i alone, the two packages
    give the same features; the port's batch i is drawn from the
    torch.Generator of SeedSequence([seed, i]) (kdip_tpu folds i into a
    jax key: a departure, pinned here), and n need not divide by the
    batch size."""
    batches = [features(4, 10 + i) for i in range(3)]
    calls, draws = [], []

    def jax_sample(key, bs):
        calls.append(key)
        return jnp.asarray(batches[len(calls) - 1][:bs])

    def torch_sample(g, bs):
        draws.append(torch.rand(2, generator=g))
        return torch.from_numpy(batches[len(draws) - 1][:bs])

    def extract(b):
        return b * 2.0 + 1.0
    want = je.compute_features(jax_sample, extract, 10, 4,
                               jax.random.key(0))
    got = te.compute_features(torch_sample, extract, 10, 4, seed=7,
                              device="cpu")
    assert got.shape == (10, D) and len(draws) == len(calls) == 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, d in enumerate(draws):
        torch.testing.assert_close(
            d, torch.rand(2, generator=seeded_generator("cpu", 7, i)),
            rtol=0, atol=0)
    assert not torch.equal(draws[0], draws[1])


KERNEL_SCALE = 30.0


@pytest.fixture(scope="module")
def clip_dirs(tmp_path_factory):
    """The tiny CLIPVisionConfig of tests/test_clip_extractor.py, saved by
    Flax for kdip_tpu, and the same weights converted here into the torch
    checkpoint directory that the port reads. Every dense and conv kernel
    is scaled by KERNEL_SCALE, from Flax's std ~0.006 to ~0.18 (about
    hidden_size ** -0.5): at Flax's init the pooled features of different
    images part by only ~7e-4, so that a resize or normalisation error
    moves them by less than the test's tolerance (torch's bicubic in
    place of jax's: 3e-5)."""
    pytest.importorskip("transformers")
    from transformers import (CLIPVisionConfig, CLIPVisionModel,
                              FlaxCLIPVisionModel)
    from transformers.modeling_flax_pytorch_utils import \
        load_flax_checkpoint_in_pytorch_model
    cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=32, patch_size=8)
    flax_dir = tmp_path_factory.mktemp("clip_flax")
    flax_model = FlaxCLIPVisionModel(cfg, seed=0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * KERNEL_SCALE if path[-1].key == "kernel" else a,
        flax_model.params)
    flax_model.save_pretrained(str(flax_dir), params=params)
    torch_model = CLIPVisionModel(cfg)
    load_flax_checkpoint_in_pytorch_model(
        torch_model, str(flax_dir / "flax_model.msgpack"))
    torch_dir = tmp_path_factory.mktemp("clip_torch")
    torch_model.save_pretrained(str(torch_dir))
    return str(flax_dir), str(torch_dir)


def test_clip_features_match_kdip_tpu(clip_dirs):
    """Pooled, normalised CLIP features of 16 px images (bicubic up to 32
    with jax's kernel) within 1e-4 of kdip_tpu's Flax extractor; the
    features of different images part by more than 1e-2 of the largest,
    far above that tolerance."""
    flax_dir, torch_dir = clip_dirs
    x = np.random.default_rng(0).uniform(
        -1, 1, (3, 16, 16, 3)).astype(np.float32)
    want = np.asarray(je.make_clip_extractor(flax_dir)(jnp.asarray(x)))
    got = te.make_clip_extractor(torch_dir, "cpu")(nchw(x)).numpy()
    assert got.shape == want.shape == (3, 32)
    assert np.abs(want[0] - want[1]).max() > 1e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
