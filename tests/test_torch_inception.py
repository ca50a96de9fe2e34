"""The port's FID InceptionV3 (`kdip_tpu_torch.models.inception`), its
weight conversion (`weights.inception_from_jax_params`) and its resize
(`ops.resize.jax_resize`) against `kdip_tpu`, on the CPU.

The weights are random but shaped as a trained network's: torch's default
conv init, BatchNorm weights and biases drawn as
tests/test_inception_backbone.py draws them, and running statistics from
one train-mode pass over seeded inputs. With random statistics instead,
the features of different images agree to ~4e-8 of their size, and a
comparison of them would hold little more than the biases.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu.models import inception as jinc
from kdip_tpu_torch import weights as tw
from kdip_tpu_torch.models import inception as tinc
from kdip_tpu_torch.ops.resize import jax_resize
from test_torch_port import REPO, nchw, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MANIFEST = os.path.join(REPO, "kdip_tpu", "manifests",
                        "clean_fid_inception_v3.json")


def random_inception(seed: int = 0, calib=None):
    """A full-width InceptionV3Features in eval(): default conv init from
    torch.manual_seed(seed), BatchNorm weight U(0.5, 1.5) and bias
    N(0, 0.1), running statistics of one train-mode pass over `calib`
    (NCHW in [-1, 1]; by default 4 seeded 299 px uniform inputs)."""
    torch.manual_seed(seed)
    model = tinc.InceptionV3Features()
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.weight.uniform_(0.5, 1.5)
                bn.bias.normal_(0, 0.1)
                bn.momentum = None
                bn.reset_running_stats()
        if calib is None:
            calib = np.random.default_rng(seed).uniform(
                -1, 1, (4, 3, 299, 299)).astype(np.float32)
        model.train()(torch.as_tensor(calib))
    return model.eval()


@pytest.fixture(scope="module")
def trunk():
    """The random trunk, kdip_tpu's variables of it, and one compiled
    kdip_tpu program that runs them (shared by the file's tests)."""
    model = random_inception()
    variables = jinc.convert_inception_state_dict(model.state_dict())
    apply = jax.jit(jinc.InceptionV3Features().apply)
    return model, variables, apply


@pytest.mark.parametrize("case", [
    ((64, 64), 299, "bilinear"), ((512, 512), 299, "bilinear"),
    ((64, 64), 32, "bilinear"), ((16, 16), 32, "bicubic"),
    ((256, 256), 224, "bicubic"), ((48, 64), 299, "bilinear")])
def test_jax_resize_matches_jax_image_resize(case):
    """Inception's 299 px input (up and down, and from a non-square
    image), the pixels backbone's 32 px and CLIP's bicubic: within 1e-5.
    (The port's weights are jax's eager float32 ones; jax.image.resize is
    jitted, and XLA's fusion rounds a sample's position otherwise, which
    moves a weight by up to ~1e-5 at 264 -> 228.)"""
    (h, w), out, method = case
    x = np.random.default_rng(h + w + out).uniform(
        -1, 1, (2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, out, out, 3),
                                       method))
    got = jax_resize(nchw(x), (out, out), method).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-5)


def test_jax_resize_differs_from_interpolate():
    """jax's antialiased downsampling is not F.interpolate's: the reason
    the port builds its own matrices."""
    x = nchw(np.random.default_rng(0).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32))
    plain = torch.nn.functional.interpolate(x, (32, 32), mode="bilinear")
    assert (jax_resize(x, (32, 32), "bilinear") - plain).abs().max() > 0.05


def test_state_dict_equals_the_pt_inception_manifest():
    """Key for key and shape for shape, the manifest of
    pt_inception-2015-12-05 less its fc.* entries."""
    with open(MANIFEST) as f:
        entries = json.load(f)["entries"]
    want = {k: tuple(v["shape"]) for k, v in entries.items()
            if not k.startswith("fc.")}
    got = {k: tuple(v.shape)
           for k, v in tinc.InceptionV3Features().state_dict().items()}
    assert got == want
    assert any(k.startswith("fc.") for k in entries)


def test_pth_loads_strictly_without_fc(trunk, tmp_path):
    """A .pth in pt_inception naming, fc.* and AuxLogits.* included, loads
    strictly; one missing tensor fails loudly."""
    model = trunk[0]
    sd = dict(model.state_dict())
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    torch.save(sd, tmp_path / "w.pth")
    loaded = torch.load(tmp_path / "w.pth", weights_only=True)
    extract = tinc.make_inception_extractor(loaded, "cpu")
    for k, v in extract.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(RuntimeError, match="running_var"):
        tinc.make_inception_extractor(sd, "cpu")


def test_inception_from_jax_params_round_trips(trunk):
    """convert_inception_state_dict then inception_from_jax_params gives
    the state dict back, bit for bit (num_batches_tracked aside, which the
    converter drops and a strict load fills in)."""
    model, variables, _ = trunk
    sd = tw.inception_from_jax_params(variables)
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert sd.keys() == want.keys()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    tinc.InceptionV3Features().load_state_dict(sd, strict=True)


def test_features_match_kdip_tpu(trunk):
    """[2, 2048] features at 299 px through the port (its weights from
    kdip_tpu's variables) and through InceptionV3Features.apply: rtol
    1e-3, atol 2e-4, the tolerance of kdip_tpu's own mirror test
    (test_inception_backbone.py). The images must differ in features."""
    _, variables, apply = trunk
    x = np.random.default_rng(5).uniform(
        -1, 1, (2, 299, 299, 3)).astype(np.float32)
    want = np.asarray(apply(variables, jnp.asarray(x)))
    extract = tinc.make_inception_extractor(
        tw.inception_from_jax_params(variables), "cpu")
    got = extract(nchw(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    assert np.abs(want[0] - want[1]).max() > 1e-2 * np.abs(want).max()
