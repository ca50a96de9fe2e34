"""The port's guided-diffusion crops and `ImageDataset` (`kdip_tpu_torch.
data`) against `kdip_tpu`'s, which resize with PIL, on the CPU.

`center_crop_arr` and `random_crop_arr` bit for bit on seeded uint8 images
of odd sizes (BOX halvings, then BICUBIC, in Pillow's 8-bit fixed point),
with the same RandomState draws; `resize` against PIL for each filter;
then `ImageDataset` over seeded PNGs of mixed sizes: items, class labels
and shards equal to kdip_tpu's, its PNGs read with PIL unimportable, and
`batches(num_workers=2)` equal to `num_workers=0` under random crops.
"""

import builtins
import os

import numpy as np
import pytest
from PIL import Image

from kdip_tpu import data as jdata
from kdip_tpu_torch import data as tdata

SIZES = [(37, 53), (600, 512), (513, 1025), (300, 280)]


def _image(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)


@pytest.mark.parametrize("filt", ["box", "bicubic", "lanczos"])
@pytest.mark.parametrize("src,dst", [((37, 53), (19, 26)),
                                     ((37, 53), (64, 80)),
                                     ((513, 1025), (256, 512)),
                                     ((300, 280), (257, 240))])
def test_resize_matches_pil(filt, src, dst):
    """resize(img, w, h, filter) equals PIL's Image.resize((w, h), filter)
    bit for bit: down, up, the halving of an odd size and a mixed one."""
    img = _image(src, 1)
    pil = {"box": Image.BOX, "bicubic": Image.BICUBIC,
           "lanczos": Image.LANCZOS}[filt]
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], pil))
    np.testing.assert_array_equal(tdata.resize(img, dst[1], dst[0], filt),
                                  want)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("image_size", [32, 100, 256])
def test_crops_match_kdip_tpu(hw, image_size):
    """center_crop_arr and random_crop_arr (5 draws from one RandomState on
    each side) bit for bit, the RandomStates left in the same state; an
    image smaller than the crop is scaled up by BICUBIC."""
    img = _image(hw, hw[0] * 7 + hw[1])
    np.testing.assert_array_equal(tdata.center_crop_arr(img, image_size),
                                  jdata.center_crop_arr(img, image_size))
    jr, tr = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(5):
        got = tdata.random_crop_arr(img, image_size, rng=tr)
        assert got.shape == (image_size, image_size, 3)
        np.testing.assert_array_equal(
            got, jdata.random_crop_arr(img, image_size, rng=jr))
    assert tr.randint(1 << 30) == jr.randint(1 << 30)


def _folder(root):
    """Seeded PNGs, named with a class prefix, of mixed sizes (grey and RGB
    among them)."""
    os.makedirs(root)
    specs = [("cat", (600, 512)), ("dog", (300, 280)), ("cat", (37, 53)),
             ("bird", (513, 300)), ("dog", (64, 64)), ("cat", (300, 280))]
    for i, (cls, hw) in enumerate(specs):
        img = _image(hw, 10 + i)
        if i == 4:
            img = img[..., 0]
        Image.fromarray(img).save(os.path.join(root, f"{cls}_{i:03d}.png"))
    return root


@pytest.mark.parametrize("random_crop", [False, True])
@pytest.mark.parametrize("shard", [0, 1])
def test_image_dataset_matches_kdip_tpu(tmp_path, monkeypatch, random_crop,
                                        shard):
    """Items, labels and paths against kdip_tpu's ImageDataset (PIL), with
    class_cond and 2 shards; the port reads its PNGs with PIL
    unimportable."""
    root = _folder(str(tmp_path / "img"))
    kw = dict(image_size=32, class_cond=True, random_crop=random_crop,
              shard=shard, num_shards=2, seed=4)
    jds = jdata.ImageDataset(root, **kw)
    tds = tdata.ImageDataset(root, **kw)
    assert [p.name for p in tds.paths] == [p.name for p in jds.paths]
    np.testing.assert_array_equal(tds.classes, jds.classes)
    want = [jds[i] for i in range(len(jds))]
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL is not installed")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = [tds[i] for i in range(len(tds))]
    monkeypatch.setattr(builtins, "__import__", real_import)
    for (ga, gl), (wa, wl) in zip(got, want):
        assert gl == wl
        assert ga.dtype == np.float32 and ga.shape == (3, 32, 32)
        np.testing.assert_array_equal(ga, wa.transpose(2, 0, 1))


def test_threaded_batches_equal_synchronous(tmp_path):
    """batches(num_workers=2) yields what num_workers=0 does with random
    crops (every draw made on the calling thread, in index order), over
    two shuffled epochs, and both equal kdip_tpu's synchronous batches."""
    root = _folder(str(tmp_path / "img"))
    kw = dict(image_size=32, random_crop=True, seed=6)
    sync, pooled = tdata.ImageDataset(root, **kw), tdata.ImageDataset(root,
                                                                       **kw)
    jds = jdata.ImageDataset(root, **kw)
    for epoch in range(2):
        a = list(sync.batches(4, shuffle=True, seed=epoch))
        b = list(pooled.batches(4, shuffle=True, seed=epoch,
                                num_workers=2, prefetch=1))
        w = list(jds.batches(4, shuffle=True, seed=epoch))
        assert [x.shape for x in a] == [(4, 3, 32, 32), (2, 3, 32, 32)]
        for x, y, z in zip(a, b, w):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z.transpose(0, 3, 1, 2))
