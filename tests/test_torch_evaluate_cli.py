"""The port's evaluation CLI (`kdip_tpu_torch.cli.evaluate`), its LPIPS
converter (`metrics.convert_lpips_weights`) and its timing harness
(`profiling`) against `kdip_tpu`, on the CPU (`--device cpu`).

The folders hold seeded 40 x 48 PNGs written by the port's writer and
loaded at --size 32 (Pillow's LANCZOS in both packages); "fake" is a
noised copy of "real".
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdip_tpu import evaluation as je
from kdip_tpu import metrics as jmetrics
from kdip_tpu.cli import evaluate as jcli
from kdip_tpu_torch import data, metrics, profiling
from kdip_tpu_torch.cli import evaluate as tcli
from kdip_tpu_torch.cli.sample_condition import load_lpips_params
from kdip_tpu_torch.models.inception import make_inception_extractor
from test_torch_inception import random_inception
from test_torch_metrics import random_lpips_params
from test_torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_IMAGES = 12
N_INCEPTION = 4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """real/ and fake/ folders, random LPIPS weights in kdip_tpu's npz and
    a random InceptionV3 .pth in pt_inception naming (fc.* included)."""
    root = tmp_path_factory.mktemp("evaluate")
    rng = np.random.default_rng(0)
    for d in ("real", "fake"):
        (root / d).mkdir()
    for i in range(N_IMAGES):
        img = rng.integers(0, 256, (40, 48, 3)).astype(np.float64)
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
        data.write_png(str(root / "real" / f"{i:03d}.png"),
                       img.astype(np.uint8))
        noised = np.clip(img + rng.normal(0, 20, img.shape), 0, 255)
        data.write_png(str(root / "fake" / f"{i:03d}.png"),
                       noised.astype(np.uint8))
    np.savez(root / "lpips.npz",
             params=np.array(random_lpips_params(seed=3), dtype=object))
    # BatchNorm statistics from these images, as a trained network's
    # match its data
    calib = np.stack([data.FolderOfImages(str(root / d), size=32)[i][0]
                      for d in ("real", "fake") for i in range(N_INCEPTION)])
    sd = dict(random_inception(seed=1, calib=calib).state_dict())
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    torch.save(sd, root / "pt_inception.pth")
    return root


def _argv(env, *extra):
    return [str(env / "real"), str(env / "fake"), "--size", "32",
            "--batch-size", "5", *extra]


def test_pixels_backbone_matches_kdip_tpu(env, tmp_path, monkeypatch):
    """The same JSON keys and n; the port's pixel features equal to
    kdip_tpu's (its FolderOfImages, jax.image.resize to 32 px, NHWC
    flattened); KID within 1e-3. FID within 5e-2: 12 images of 3072
    features give rank-deficient covariances, whose float32 square roots
    leave both packages 10-15% off the float64 FID of the same features
    (about 34.7, against 29.7-30.5 in float32); the function itself is
    held at full rank within 1e-4 (tests/test_torch_evaluation.py)."""
    import jax
    from kdip_tpu.data import FolderOfImages as JFolder
    want = jcli.main(_argv(env))
    feats, features = [], tcli.folder_features

    def recorded(*a):
        feats.append(features(*a))
        return feats[-1]
    monkeypatch.setattr(tcli, "folder_features", recorded)
    got = tcli.main(_argv(env, "--device", "cpu", "--out",
                          str(tmp_path / "o.json")))
    assert set(got) == set(want) == {"fid", "kid", "n_real", "n_fake",
                                     "backbone"}
    assert (got["n_real"], got["n_fake"], got["backbone"]) == (
        N_IMAGES, N_IMAGES, "pixels")
    for d, f in zip(("real", "fake"), feats):
        ds = JFolder(str(env / d), size=32)
        x = jnp.asarray(np.stack([ds[i][0] for i in range(N_IMAGES)]))
        ref = jax.image.resize(x, (N_IMAGES, 32, 32, 3), "bilinear")
        np.testing.assert_allclose(f.numpy(), np.asarray(ref).reshape(
            N_IMAGES, -1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["kid"], want["kid"], rtol=1e-3)
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=5e-2)
    with open(tmp_path / "o.json") as f:
        assert json.load(f) == got


def test_paired_matches_kdip_tpu(env):
    """--paired with LPIPS over the first 3 pairs: psnr, ssim and lpips
    averaged as kdip_tpu averages them."""
    argv = _argv(env, "--paired", "--lpips-weights", str(env / "lpips.npz"),
                 "--max-images", "3")
    want = jcli.main(argv)
    got = tcli.main(argv + ["--device", "cpu"])
    assert set(got) == set(want) == {"psnr", "ssim", "lpips", "n"}
    assert got["n"] == want["n"] == 3
    for k in ("psnr", "ssim", "lpips"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_inception_backbone_from_a_pth(env):
    """--backbone inception reads the .pth (fc.* dropped) and reports
    kdip_tpu.evaluation's FID and KID of the port extractor's features of
    the same images."""
    out = tcli.main(_argv(env, "--backbone", "inception", "--weights",
                          str(env / "pt_inception.pth"), "--max-images",
                          str(N_INCEPTION), "--device", "cpu"))
    assert (out["n_real"], out["n_fake"]) == (N_INCEPTION, N_INCEPTION)
    extract = make_inception_extractor(
        torch.load(env / "pt_inception.pth", weights_only=True), "cpu")
    feats = []
    for d in ("real", "fake"):
        ds = data.FolderOfImages(str(env / d), size=32)
        batch = np.stack([ds[i][0] for i in range(N_INCEPTION)])
        feats.append(jnp.asarray(extract(torch.from_numpy(batch)).numpy()))
    np.testing.assert_allclose(out["fid"], float(je.fid(*feats)), rtol=1e-3)
    np.testing.assert_allclose(out["kid"], float(je.kid(*feats)), rtol=1e-3,
                               atol=1e-6)
    assert out["fid"] > 0


def _vgg_and_lpips_state_dicts(seed: int):
    """Seeded torchvision VGG16 `features.*` convs and lpips' lin layers,
    as torch tensors."""
    g = torch.Generator().manual_seed(seed)
    vgg, layer, c_in = {}, 0, 3
    for c in metrics.VGG16_CFG:
        if c == "M":
            layer += 1
            continue
        vgg[f"features.{layer}.weight"] = torch.randn(c, c_in, 3, 3,
                                                      generator=g)
        vgg[f"features.{layer}.bias"] = torch.randn(c, generator=g)
        layer, c_in = layer + 2, c
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
           for i, c in enumerate((64, 128, 256, 512, 512))}
    return vgg, lin


def test_convert_lpips_weights_matches_kdip_tpu(tmp_path):
    """The same tree as kdip_tpu.metrics.convert_lpips_weights, bit for
    bit; saved as the npz, the CLIs' loader gives back the VGG convs."""
    vgg, lin = _vgg_and_lpips_state_dicts(0)
    got = metrics.convert_lpips_weights(vgg, lin)
    want = jmetrics.convert_lpips_weights(
        {k: v.numpy() for k, v in vgg.items()},
        {k: v.numpy() for k, v in lin.items()})
    assert got.keys() == want.keys()
    for mod in want:
        assert got[mod].keys() == want[mod].keys()
        for leaf in want[mod]:
            np.testing.assert_array_equal(got[mod][leaf], want[mod][leaf])
    np.savez(tmp_path / "l.npz", params=np.array(got, dtype=object))
    params = load_lpips_params(str(tmp_path / "l.npz"), torch.device("cpu"))
    torch.testing.assert_close(params["conv12.weight"],
                               vgg["features.28.weight"], rtol=0, atol=0)
    torch.testing.assert_close(params["lin4.weight"],
                               lin["lin4.model.1.weight"][0, :, 0, 0],
                               rtol=0, atol=0)


def test_profiling_helpers_on_the_cpu(tmp_path):
    """timeit counts warm-up and timed calls; trace writes a Chrome trace
    and yields the profiler."""
    calls = []

    def fn(x):
        calls.append(1)
        return {"out": (x * 2,)}
    x = torch.ones(4)
    assert profiling.timeit(fn, x, iters=4, warmup=2) > 0
    assert len(calls) == 6
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("case", ["dp", "orbax", "clip_without_transformers",
                                  "no_card"])
def test_refusals(env, tmp_path, case, monkeypatch):
    """What the port does not run exits saying why: --dp without a process
    group to join (no launcher's environment) names torchrun, an orbax
    directory of weights is refused, --backbone clip without transformers
    names the package (no other backbone stands in), and --device cuda
    without a card never falls back to the CPU. (--dp over two ranks:
    test_torch_parallel_ranks.py.)"""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "OMPI_COMM_WORLD_SIZE", "SLURM_JOB_ID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    argv, match = {
        "dp": (_argv(env, "--dp", "--device", "cpu"),
               "--dp needs a process group: launch with torchrun"),
        "orbax": (_argv(env, "--backbone", "inception", "--weights",
                        str(tmp_path), "--device", "cpu"), "orbax"),
        "clip_without_transformers": (
            _argv(env, "--backbone", "clip", "--weights", str(tmp_path),
                  "--device", "cpu"), "transformers"),
        "no_card": (_argv(env), "no CUDA card"),
    }[case]
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv)
