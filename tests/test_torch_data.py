"""The port's image folder and PNG codec (`kdip_tpu_torch.data`) against
`kdip_tpu.data.FolderOfImages`: the same files give the same arrays bit for
bit, the port's in NCHW. 8-bit PNGs of colour type 0, 2, 4 and 6 go
through the port's own reader (no PIL); every other file goes through PIL
in both packages."""

import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from kdip_tpu import data as jdata
from kdip_tpu.cli import sample_condition as jcli
from kdip_tpu_torch import data as tdata


def _images(seed: int = 0):
    """A noisy RGBA image and a smooth one (PIL's adaptive filter picks
    Sub, Up and Paeth on it rather than None), 40 x 48."""
    rng = np.random.RandomState(seed)
    noisy = (rng.rand(40, 48, 4) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:40, :48]
    smooth = np.stack([(3 * xx + 2 * yy) % 256, (xx * yy) % 256,
                       (5 * yy) % 256, 255 - xx], -1).astype(np.uint8)
    return noisy, smooth


def _filters(path):
    """The row filter types of a PNG file."""
    data = open(path, "rb").read()
    raw = zlib.decompress(b"".join(p for k, p in tdata._chunks(data)
                                   if k == b"IDAT"))
    w, h, _, ctype, _ = tdata.png_header(path)
    stride = 1 + w * tdata._PNG_CHANNELS[ctype]
    return {raw[y * stride] for y in range(h)}


def _assert_same_arrays(root):
    """Both folders list the same files, and every array is equal."""
    jset, tset = jdata.FolderOfImages(root), tdata.FolderOfImages(root)
    assert [p.relative_to(root) for p in tset.paths] == \
        [p.relative_to(root) for p in jset.paths]
    for i in range(len(jset)):
        want, = jset[i]
        got, = tset[i]
        assert got.dtype == np.float32 and got.shape == (3,) + want.shape[:2]
        np.testing.assert_array_equal(got.transpose(1, 2, 0), want)
    return tset


def test_pil_pngs_match_and_skip_pil(tmp_path, monkeypatch):
    """PIL-written RGB, RGBA, L and LA PNGs (adaptive filters) read by the
    port's decoder equal kdip_tpu's PIL arrays bit for bit, with PIL made
    unimportable for the port's reads, as on the card's machine."""
    noisy, smooth = _images()
    (tmp_path / "sub").mkdir()
    files = {"a_rgb.png": (noisy[..., :3], "RGB"),
             "b_rgba.png": (noisy, "RGBA"),
             "c_l.png": (noisy[..., 0], "L"),
             "sub/d_la.png": (noisy[..., :2], "LA"),
             "sub/e_smooth.png": (smooth[..., :3], "RGB"),
             "f_smooth_rgba.PNG": (smooth, "RGBA")}
    filters = set()
    for name, (arr, mode) in files.items():
        Image.fromarray(arr, mode).save(tmp_path / name)
        assert tdata.decodes_natively(tmp_path / name)
        filters |= _filters(tmp_path / name)
    assert {1, 2, 4} <= filters
    jset = jdata.FolderOfImages(tmp_path)
    want = [jset[i][0] for i in range(len(jset))]
    monkeypatch.setitem(sys.modules, "PIL", None)
    tset = tdata.FolderOfImages(tmp_path)
    assert len(tset) == len(files)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(tset[i][0].transpose(1, 2, 0), w)


def _encode_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit RGB PNG whose row y uses filter filters[y % len(filters)]
    (the PNG specification's five filters, written out here)."""
    h, w, bpp = img.shape
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
    return _encode_raw_png(bytes(out), w, h)


def _encode_raw_png(raw: bytes, w: int, h: int) -> bytes:
    """An 8-bit RGB PNG of w x h whose filtered rows are `raw`."""
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    return (tdata.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def test_all_five_row_filters(tmp_path):
    """Rows filtered None, Sub, Up, Average and Paeth in turn decode to the
    image, as PIL decodes them and as kdip_tpu's folder reads them."""
    noisy, smooth = _images(seed=1)
    for name, img in (("n.png", noisy[..., :3]), ("s.png", smooth[..., :3])):
        (tmp_path / name).write_bytes(_encode_png(img, (0, 1, 2, 3, 4)))
        assert _filters(tmp_path / name) == {0, 1, 2, 3, 4}
        np.testing.assert_array_equal(tdata.read_png(tmp_path / name), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / name)), img)
    _assert_same_arrays(tmp_path)


@pytest.mark.parametrize("filters", [(4, 3, 2, 1, 0),
                                     (2, 2, 1, 1, 0, 3, 3, 4, 4, 1)])
def test_row_filters_in_other_orders(tmp_path, filters):
    """read_png decodes the None and Sub rows all at once and then the
    others in order, each on the row above: Paeth, Average or Up on the
    first row (the row above taken as 0) and runs of one filter decode to
    the image, as PIL decodes them; a filter type past 4 is refused."""
    noisy, smooth = _images(seed=2)
    for name, img in (("n.png", noisy[..., :3]), ("s.png", smooth[..., :3])):
        (tmp_path / name).write_bytes(_encode_png(img, filters))
        assert _filters(tmp_path / name) == set(filters)
        np.testing.assert_array_equal(tdata.read_png(tmp_path / name), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / name)), img)
    bad = bytearray(zlib.decompress(b"".join(
        p for k, p in tdata._chunks((tmp_path / "s.png").read_bytes())
        if k == b"IDAT")))
    bad[7 * (1 + 48 * 3)] = 5
    (tmp_path / "bad.png").write_bytes(
        _encode_raw_png(bytes(bad), 48, 40))
    with pytest.raises(ValueError, match="row 7 has filter type 5"):
        tdata.read_png(tmp_path / "bad.png")


def test_other_files_go_through_pil(tmp_path):
    """A JPEG, a palette PNG, a 16-bit PNG, an interlaced PNG and a JPEG
    named .png are PIL's, chosen from the extension and the header; under
    size= these are too (PIL's LANCZOS resize; an 8-bit PNG that read_png
    takes is resized without PIL, tests/test_torch_train_data.py). Arrays
    equal kdip_tpu's."""
    noisy, smooth = _images(seed=2)
    Image.fromarray(smooth[..., :3]).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(smooth[..., :3]).convert("P").save(tmp_path / "b.png")
    Image.fromarray((smooth[..., 0].astype(np.uint16) * 257)).save(
        tmp_path / "c.png")
    Image.fromarray(noisy[..., :3]).save(tmp_path / "d.jpg")
    (tmp_path / "e.png").write_bytes((tmp_path / "d.jpg").read_bytes())
    hdr = tdata.png_header(tmp_path / "b.png")
    assert hdr[3] == 3 and tdata.png_header(tmp_path / "c.png")[2] == 16
    assert tdata.png_header(tmp_path / "e.png") is None
    for name in ("a.jpg", "b.png", "c.png", "e.png"):
        assert not tdata.decodes_natively(tmp_path / name)
    _assert_same_arrays(tmp_path)
    jset = jdata.FolderOfImages(tmp_path, size=16)
    tset = tdata.FolderOfImages(tmp_path, size=16)
    for i in range(len(jset)):
        np.testing.assert_array_equal(tset[i][0].transpose(1, 2, 0),
                                      jset[i][0])


def test_interlaced_png_is_refused_by_the_reader(tmp_path):
    """An Adam7 header sends the file to PIL; read_png itself refuses it."""
    path = tmp_path / "i.png"
    data = bytearray(_encode_png(_images()[0][..., :3], (0,)))
    ihdr = bytes(data[12:29])
    data[28] = 1  # interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(ihdr[:16] + b"\x01"))
    path.write_bytes(bytes(data))
    assert tdata.png_header(path)[4] == 1
    assert not tdata.decodes_natively(path)
    with pytest.raises(ValueError, match="PIL"):
        tdata.read_png(path)


def test_writer_and_uint8_rounding(tmp_path):
    """to_uint8_image rounds as kdip_tpu's to_pil_image; write_png's file
    reads back through PIL and through read_png unchanged; a transform
    takes the [C, H, W] array."""
    rng = np.random.RandomState(3)
    x = rng.uniform(-1.2, 1.2, (3, 20, 24)).astype(np.float32)
    img = tdata.to_uint8_image(x)
    np.testing.assert_array_equal(
        img, np.asarray(jcli.to_pil_image(x.transpose(1, 2, 0))))
    tdata.write_png(tmp_path / "w.png", img)
    tdata.write_png(tmp_path / "g.png", img[..., 1])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")),
                                  img)
    np.testing.assert_array_equal(tdata.read_png(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(
        tdata.read_png(tmp_path / "g.png")[..., 0], img[..., 1])
    tset = tdata.FolderOfImages(tmp_path, transform=lambda a: a[:1])
    assert tset[1][0].shape == (1, 20, 24)
    with pytest.raises(ValueError):
        tdata.write_png(tmp_path / "bad.png", np.zeros((4, 4, 4), np.uint8))
