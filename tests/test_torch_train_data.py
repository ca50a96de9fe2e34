"""The training input pipeline of the port (`kdip_tpu_torch.data`) against
`kdip_tpu.data` and Pillow: the numpy LANCZOS resize bit for bit against
PIL's `resize(..., Image.LANCZOS)`, `FolderOfImages(size=)` without PIL,
`batches` in `kdip_tpu`'s order with and without a thread pool, and the
Karras augmentation; arrays compared after NHWC -> NCHW."""

import sys

import numpy as np
import pytest
from PIL import Image

from kdip_tpu import data as jdata
from kdip_tpu_torch import data as tdata


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Seven 32 x 32 RGB PNGs, one grey and one RGBA 32 x 32 PNG, a
    48 x 40 RGB PNG (a downscale under size=32), a 24 x 24 one (an
    upscale), and their kdip_tpu datasets (PIL decodes and resizes)."""
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.RandomState(0)
    for i in range(7):
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(
            root / f"img_{i}.png")
    Image.fromarray((rng.rand(32, 32) * 255).astype(np.uint8)).save(
        root / "grey.png")
    Image.fromarray((rng.rand(32, 32, 4) * 255).astype(np.uint8)).save(
        root / "rgba.png")
    Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)).save(
        root / "wide.png")
    Image.fromarray((rng.rand(24, 24, 3) * 255).astype(np.uint8)).save(
        root / "small.png")
    return root, jdata.FolderOfImages(root, size=32)


@pytest.mark.parametrize("shape,size", [
    ((40, 48, 3), (32, 32)),    # downscale, non-square in
    ((24, 24, 3), (32, 32)),    # upscale
    ((50, 37, 3), (29, 21)),    # non-square out, both axes odd
    ((30, 44, 1), (32, 16)),    # grey, one axis up and one down
])
def test_lanczos_resize_is_pils(shape, size):
    """resize_lanczos equals PIL's LANCZOS resize bit for bit (a grey
    image as PIL's convert("RGB") replicates it)."""
    rng = np.random.RandomState(shape[0])
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    pil = Image.fromarray(img[..., 0] if shape[2] == 1 else img)
    want = np.asarray(pil.convert("RGB").resize(size, Image.LANCZOS))
    got = tdata.resize_lanczos(np.repeat(img, 3 // shape[2], axis=2), *size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_folder_with_size_needs_no_pil(folder, monkeypatch, tmp_path):
    """FolderOfImages(size=32) over the folder, with PIL made unimportable
    for the port: every item (the same-size PNGs served as read_png reads
    them, the resized ones through resize_lanczos) equals kdip_tpu's,
    which PIL decodes and resizes. A file only PIL decodes then raises an
    ImportError that names it."""
    root, jset = folder
    want = [jset[i][0] for i in range(len(jset))]
    monkeypatch.setitem(sys.modules, "PIL", None)
    tset = tdata.FolderOfImages(root, size=32)
    assert len(tset) == len(want) == 11
    for i, w in enumerate(want):
        got, = tset[i]
        assert got.shape == (3, 32, 32), tset.paths[i]
        np.testing.assert_array_equal(got.transpose(1, 2, 0), w,
                                      err_msg=str(tset.paths[i]))
    (tmp_path / "photo.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ImportError, match="photo.jpg"):
        tdata.FolderOfImages(tmp_path, size=32)[0]


@pytest.mark.parametrize("shuffle,drop_last,workers", [
    (False, False, 0), (True, True, 0), (True, False, 2), (False, True, 2)])
def test_batches_match(folder, shuffle, drop_last, workers):
    """batches(4) yields kdip_tpu's batches (its synchronous path: the
    RandomState(seed) shuffle, drop_last), [B, C, H, W]; with a pool of 2
    threads the same, in the same order."""
    root, jset = folder
    tset = tdata.FolderOfImages(root, size=32)
    want = list(jset.batches(4, drop_last=drop_last, shuffle=shuffle,
                             seed=3))
    got = list(tset.batches(4, drop_last=drop_last, shuffle=shuffle, seed=3,
                            num_workers=workers, prefetch=1))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.transpose(0, 2, 3, 1), w)


@pytest.mark.parametrize("a_prob", [0.0, 0.5])
def test_augmentation_matches(a_prob):
    """augment_batch over a [B, C, H, W] batch (images in [-1, 1], and
    one in [0, 1], which the pipeline takes as it is) equals kdip_tpu's
    over the NHWC batch bit for bit: the augmented and the original
    images and the 9-dim conditioning."""
    rng = np.random.RandomState(1)
    batch = rng.uniform(-1, 1, (5, 20, 24, 3)).astype(np.float32)
    batch[4] = (batch[4] + 1) / 2
    pipe_j = jdata.KarrasAugmentationPipeline(a_prob=a_prob)
    pipe_t = tdata.KarrasAugmentationPipeline(a_prob=a_prob)
    want = jdata.augment_batch(pipe_j, batch, seed=17)
    got = tdata.augment_batch(pipe_t, np.ascontiguousarray(
        batch.transpose(0, 3, 1, 2)), seed=17)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.transpose(0, 2, 3, 1), w)
    np.testing.assert_array_equal(got[2], want[2])
    if a_prob:
        assert np.abs(want[2][:, 1:]).sum() > 0  # some draw augmented
