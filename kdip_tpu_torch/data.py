"""The image folder, its batches and augmentation, and the port's PNG codec
(PyTorch port of `kdip_tpu/data.py`; ref:
k_diffusion/utils.py:274-297, k_diffusion/augmentation.py:13-86).

`FolderOfImages` is a sorted recursive glob that returns `(arr,)`, arr a
float32 [C, H, W] array in [-1, 1]. So that a machine without PIL can
read it, an 8-bit non-interlaced PNG of colour type 0, 2, 4 or 6 (grey,
RGB, grey + alpha, RGBA) is decoded here: zlib, the five PNG row filters
and numpy, the counterpart of the PNG path of `kdip_tpu`'s native loader
(`kdip_tpu/native/loader.cc`). Under `size=` such a PNG is resized here
too, by `resize_lanczos`, which reproduces Pillow's 8-bit LANCZOS
(Resample.c) bit for bit as loader.cc:49-195 does. Every other file goes
through PIL as `kdip_tpu` reads it; the choice is made from the extension
and the PNG header. `batches` yields [B, C, H, W] batches, decoded by a
thread pool when `num_workers > 0`, every random draw made in index order
on the calling thread. `ImageDataset` (labels from the file names,
shards) crops as guided-diffusion does: `center_crop_arr` and
`random_crop_arr` halve with Pillow's BOX and scale with its BICUBIC
(`resize`, which also does LANCZOS), bit for bit, without PIL.
`KarrasAugmentationPipeline` and `augment_batch` are `kdip_tpu`'s, on
[C, H, W]. `write_png` writes the
CLIs' 8-bit RGB PNGs.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import reduce
from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp"}

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the 8-bit types this reader takes
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def png_header(path) -> Optional[Tuple[int, int, int, int, int]]:
    """(width, height, bit depth, colour type, interlace) of a PNG file,
    from its signature and IHDR chunk; None if the file is no PNG."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 33 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        return None
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        head[16:29])
    return w, h, depth, ctype, interlace


def decodes_natively(path) -> bool:
    """Whether `read_png` takes the file: a .png whose header says 8-bit,
    non-interlaced, colour type 0, 2, 4 or 6."""
    if Path(path).suffix.lower() != ".png":
        return False
    hdr = png_header(path)
    return (hdr is not None and hdr[2] == 8 and hdr[3] in _PNG_CHANNELS
            and hdr[4] == 0)


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    pos = 8
    while pos + 12 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> np.ndarray:
    cur = bytearray(len(line))
    for i in range(len(line)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> np.ndarray:
    cur = bytearray(len(line))
    for i in range(len(line)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (line[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit non-interlaced PNG of colour type 0, 2, 4 or 6 as a uint8
    [H, W, channels] array (see decodes_natively)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    hdr, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: {depth}-bit colour type {ctype} "
                         f"interlace {interlace} is PIL's to decode")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + stride):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for "
                         f"{h} rows of {stride}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + stride)
    ftypes, lines = rows[:, 0], rows[:, 1:]
    if h and ftypes.max() > 4:
        y = int(np.argmax(ftypes > 4))
        raise ValueError(f"{path}: row {y} has filter type {ftypes[y]}")
    # None and Sub rows need no row above: all of them at once, so that
    # an unfiltered file (`write_png`'s) decodes without a Python loop
    out = np.array(lines)       # the None rows; the others overwritten
    sub = np.flatnonzero(ftypes == 1)
    if len(sub):    # Sub: a running sum per channel, mod 256
        out[sub] = np.cumsum(lines[sub].reshape(len(sub), w, bpp), axis=1,
                             dtype=np.uint8).reshape(len(sub), stride)
    # Up, Average and Paeth rows in order, each on the row above it
    zero = np.zeros(stride, np.uint8)
    for y in np.flatnonzero(ftypes >= 2):
        prev, line = (out[y - 1] if y else zero), lines[y]
        if ftypes[y] == 2:      # Up
            out[y] = line + prev
        elif ftypes[y] == 3:
            out[y] = _unfilter_average(line.tobytes(), prev.tobytes(), bpp)
        else:
            out[y] = _unfilter_paeth(line.tobytes(), prev.tobytes(), bpp)
    return out.reshape(h, w, bpp)


def write_png(path, img: np.ndarray) -> None:
    """Writes a uint8 [H, W, 3] (RGB) or [H, W] (grey) array as an 8-bit
    PNG, every row unfiltered, zlib level 6."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3], got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def to_uint8_image(x) -> np.ndarray:
    """A [-1, 1] [C, H, W] tensor or array -> uint8 [H, W, C], as
    `kdip_tpu`'s to_pil_image rounds it (ref: k_diffusion/utils.py:24-37)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    arr = np.clip((np.asarray(x, np.float32) + 1) / 2, 0, 1)
    return (arr * 255).astype(np.uint8).transpose(1, 2, 0)


def _rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, channels] of a PNG colour type -> [H, W, 3], as PIL's
    convert("RGB") takes it: grey replicated, alpha dropped."""
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


# ---------------------------------------------------------------------------
# Pillow's 8-bit resize with the BOX, BICUBIC and LANCZOS filters (Pillow
# src/libImaging/Resample.c, as kdip_tpu/native/loader.cc:49-195 reproduces
# it)
# ---------------------------------------------------------------------------

PRECISION_BITS = 32 - 8 - 2     # 22: the taps' fixed-point bits


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


def _box(x: float) -> float:
    return 1.0 if -0.5 < x <= 0.5 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# name -> (Pillow's filter function, its support)
FILTERS = {"box": (_box, 0.5), "bicubic": (_bicubic, 2.0),
           "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=64)
def resample_taps(in_size: int, out_size: int, filter_name: str
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc over the whole
    axis for one of FILTERS: (xmin [out], taps [out, ksize] int64). Each
    output's taps are normalised in double (summed in order, as C does),
    scaled by 2^PRECISION_BITS and rounded half away from zero, and are 0
    past its xmax. Scalar Python floats keep C's libm calls and roundings;
    the arrays are read-only (cached)."""
    filt, filter_support = FILTERS[filter_name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        taps[xx, :xmax] = [int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0
                           else int(0.5 + w * (1 << PRECISION_BITS))
                           for w in k]
        xmins[xx] = xmin
    xmins.setflags(write=False)
    taps.setflags(write=False)
    return xmins, taps


def _resample_pass(img: np.ndarray, out_size: int, axis: int,
                   filter_name: str) -> np.ndarray:
    """One of Pillow's two passes along `axis` of a uint8 [H, W, C] image:
    per output, the accumulator starts at 2^(PRECISION_BITS-1), adds each
    tap times its pixel (a gather per tap, over every row and channel at
    once), and clip8 takes the top bits (a negative sum, which BICUBIC's
    negative taps can give, clips to 0)."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    n_in = src.shape[0]
    xmins, taps = resample_taps(n_in, out_size, filter_name)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    bcast = (-1,) + (1,) * (src.ndim - 1)
    for k in range(taps.shape[1]):
        # a tap past xmax is 0, so its clamped index adds nothing
        idx = np.minimum(xmins + k, n_in - 1)
        acc += src[idx] * taps[:, k].reshape(bcast)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize(img: np.ndarray, width: int, height: int,
           filter_name: str) -> np.ndarray:
    """A uint8 [H, W, C] image resized as Pillow's
    `Image.resize((width, height), filter)` resizes it, bit for bit, for
    filter_name "box", "bicubic" or "lanczos": the horizontal pass first,
    then the vertical, each only where that size changes (at the same
    size, a copy)."""
    if img.shape[1] != width:
        img = _resample_pass(img, width, 1, filter_name)
    if img.shape[0] != height:
        img = _resample_pass(img, height, 0, filter_name)
    return img.copy()


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`resize` with Pillow's LANCZOS."""
    return resize(img, width, height, "lanczos")


# ---------------------------------------------------------------------------
# guided-diffusion's crops (ref: guided_diffusion/image_datasets.py:126-167;
# `kdip_tpu` data.py:143-188), on uint8 [H, W, C] arrays
# ---------------------------------------------------------------------------

def _scaled_size(w: int, h: int, smaller: int) -> Tuple[Tuple[int, int],
                                                         int]:
    """The crops' resize arithmetic on a w x h image: ((w, h) after the
    BOX halvings, while the smaller side is at least 2 x `smaller`;
    (width, height) after the BICUBIC scale to `smaller`), and the number
    of halvings."""
    halvings = 0
    while min(w, h) >= 2 * smaller:
        w, h = w // 2, h // 2
        halvings += 1
    scale = smaller / min(w, h)
    return (round(w * scale), round(h * scale)), halvings


def _scale_to(arr: np.ndarray, smaller: int) -> np.ndarray:
    """Halve with BOX while the smaller side is at least 2 x `smaller`, then
    BICUBIC to a smaller side of `smaller`, as Pillow computes both."""
    arr = np.ascontiguousarray(arr, np.uint8)
    (nw, nh), halvings = _scaled_size(arr.shape[1], arr.shape[0], smaller)
    for _ in range(halvings):
        arr = resize(arr, arr.shape[1] // 2, arr.shape[0] // 2, "box")
    return resize(arr, nw, nh, "bicubic")


def center_crop_arr(arr: np.ndarray, image_size: int) -> np.ndarray:
    """Downscale, then the centre image_size x image_size crop
    (ref: guided_diffusion/image_datasets.py:126-147): `kdip_tpu`'s PIL
    arithmetic bit for bit, without PIL. uint8 [H, W, C] in and out (a
    float array is cast to uint8 first, as kdip_tpu casts it)."""
    out = _scale_to(arr.astype(np.uint8), image_size)
    crop_y = (out.shape[0] - image_size) // 2
    crop_x = (out.shape[1] - image_size) // 2
    return out[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


def _random_crop_draws(w: int, h: int, image_size: int,
                       rng: np.random.RandomState,
                       min_crop_frac: float = 0.8, max_crop_frac: float = 1.0,
                       smaller_dim_size: Optional[int] = None):
    """random_crop_arr's draws for a w x h image, in its order: the scale
    (unless given), then the crop's y and x offsets. Returns (smaller,
    crop_y, crop_x)."""
    if smaller_dim_size is None:
        min_smaller = math.ceil(image_size / max_crop_frac)
        max_smaller = math.floor(image_size / min_crop_frac)
        smaller_dim_size = int(rng.randint(min_smaller, max_smaller + 1))
    (nw, nh), _ = _scaled_size(w, h, smaller_dim_size)
    crop_y = int(rng.randint(nh - image_size + 1))
    crop_x = int(rng.randint(nw - image_size + 1))
    return smaller_dim_size, crop_y, crop_x


def _crop_at(arr: np.ndarray, image_size: int, smaller: int, crop_y: int,
             crop_x: int) -> np.ndarray:
    out = _scale_to(arr, smaller)
    return out[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


def random_crop_arr(arr: np.ndarray, image_size: int,
                    min_crop_frac: float = 0.8, max_crop_frac: float = 1.0,
                    rng: Optional[np.random.RandomState] = None,
                    smaller_dim_size: Optional[int] = None) -> np.ndarray:
    """Random-scale crop (ref: guided_diffusion/image_datasets.py:150-167):
    the smaller side drawn from `rng` in [ceil(size / max_crop_frac),
    floor(size / min_crop_frac)] (or `smaller_dim_size`), the image scaled
    to it as center_crop_arr scales, then the crop's offsets drawn: the
    draws and the pixels of `kdip_tpu`'s PIL version."""
    rng = rng or np.random.RandomState()
    arr = arr.astype(np.uint8)
    draws = _random_crop_draws(arr.shape[1], arr.shape[0], image_size, rng,
                               min_crop_frac, max_crop_frac, smaller_dim_size)
    return _crop_at(arr, image_size, *draws)


class FolderOfImages:
    """Recursive image folder dataset, no classes
    (ref: k_diffusion/utils.py:274-297). Returns float32 [C, H, W] arrays
    in [-1, 1]; `transform` is applied to that array. Under `size=` every
    image is resized to size x size with LANCZOS, as `kdip_tpu` resizes it:
    a PNG that `read_png` takes needs no PIL for that."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 size: Optional[int] = None):
        self.root = Path(root)
        self.transform = transform
        self.size = size
        self.paths = sorted(p for p in self.root.rglob("*")
                            if p.suffix.lower() in IMG_EXTENSIONS)

    def __len__(self):
        return len(self.paths)

    def _uint8_rgb(self, path) -> np.ndarray:
        if decodes_natively(path):
            img = _rgb(read_png(path))
            if self.size is not None:
                img = resize_lanczos(img, self.size, self.size)
            return img
        try:
            from PIL import Image
        except ImportError:
            raise ImportError(
                f"{path}: only an 8-bit non-interlaced PNG decodes without "
                "PIL, and PIL is not installed") from None
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.size is not None:
                img = img.resize((self.size, self.size), Image.LANCZOS)
            return np.asarray(img)

    def _draw(self, idx):
        """Item idx's random draws, made on the calling thread in index
        order (FolderOfImages draws none)."""
        return None

    def _load(self, idx, draws) -> Tuple[np.ndarray, ...]:
        """Item idx from its draws: what a pool thread runs."""
        arr = self._uint8_rgb(self.paths[idx]).astype(np.float32) / 255.0
        arr = np.ascontiguousarray((arr * 2 - 1).transpose(2, 0, 1))
        if self.transform is not None:
            arr = self.transform(arr)
        return (arr,)

    def __getitem__(self, idx) -> Tuple[np.ndarray, ...]:
        return self._load(idx, self._draw(idx))

    def batches(self, batch_size: int, drop_last: bool = False,
                shuffle: bool = False, seed: int = 0,
                num_workers: int = 0, prefetch: int = 2
                ) -> Iterator[np.ndarray]:
        """Yield float32 [B, C, H, W] batches in `kdip_tpu`'s order (a
        RandomState(seed) shuffle of the indices). With num_workers > 0 a
        pool of that many threads decodes the items, `prefetch` batches
        ahead of the one yielded: the same batches, in the same order, as
        the synchronous path (`kdip_tpu`'s contract for its native loader,
        data.py:58-73). Each item's random draws are made on this thread,
        in index order, as its batch is submitted (`kdip_tpu`'s
        `_native_spec`); so, as there, a stream abandoned mid-epoch leaves
        the dataset's RandomState up to `prefetch` batches further on."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        groups = [order[i:i + batch_size]
                  for i in range(0, len(order), batch_size)]
        if drop_last and groups and len(groups[-1]) < batch_size:
            groups.pop()
        if num_workers <= 0:
            for idxs in groups:
                yield np.stack([self[j][0] for j in idxs])
            return
        pool = ThreadPoolExecutor(num_workers)
        pending = deque()
        try:
            for idxs in groups:
                pending.append([pool.submit(self._load, j, self._draw(j))
                                for j in idxs])
                if len(pending) > prefetch:
                    yield np.stack([f.result()[0]
                                    for f in pending.popleft()])
            while pending:
                yield np.stack([f.result()[0] for f in pending.popleft()])
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


class ImageDataset(FolderOfImages):
    """Class-conditional image dataset with guided-diffusion's crops
    (ref: guided_diffusion/image_datasets.py:11-124; `kdip_tpu` data.py:
    191-262): each image centre-cropped, or with `random_crop` randomly
    scaled and cropped, to image_size x image_size; float32 [C, H, W] in
    [-1, 1], and with `class_cond` the class index, from the file name's
    prefix before its first underscore (the sorted prefixes numbered).
    `shard` / `num_shards` take every num_shards-th path from `shard` on.
    The random draws come from RandomState(seed), in kdip_tpu's order: an
    8-bit PNG's size from its header (else PIL's), then the scale and the
    offsets, before it is decoded; a PNG needs no PIL."""

    def __init__(self, root: str, image_size: int, class_cond: bool = False,
                 random_crop: bool = False, shard: int = 0,
                 num_shards: int = 1, seed: int = 0):
        super().__init__(root)
        self.paths = self.paths[shard::num_shards]
        self.image_size = image_size
        self.random_crop = random_crop
        self.rng = np.random.RandomState(seed)
        self.classes = None
        if class_cond:
            names = [p.name.split("_")[0] for p in self.paths]
            sorted_classes = {c: i for i, c in enumerate(sorted(set(names)))}
            self.classes = np.array([sorted_classes[n] for n in names])

    def _size(self, path) -> Tuple[int, int]:
        if decodes_natively(path):
            return png_header(path)[:2]
        from PIL import Image
        with Image.open(path) as img:
            return img.size

    def _draw(self, idx):
        if not self.random_crop:
            return None
        w, h = self._size(self.paths[idx])
        return _random_crop_draws(w, h, self.image_size, self.rng)

    def _load(self, idx, draws):
        arr = self._uint8_rgb(self.paths[idx])
        if draws is None:
            arr = center_crop_arr(arr, self.image_size)
        else:
            arr = _crop_at(arr, self.image_size, *draws)
        arr = np.ascontiguousarray(
            (arr.astype(np.float32) / 127.5 - 1).transpose(2, 0, 1))
        if self.classes is not None:
            return arr, int(self.classes[idx])
        return (arr,)


# ---------------------------------------------------------------------------
# Karras augmentation (ref: k_diffusion/augmentation.py:13-86)
# ---------------------------------------------------------------------------

def _translate2d(tx, ty):
    return np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)


def _scale2d(sx, sy):
    return np.array([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], np.float64)


def _rotate2d(theta):
    return np.array([[math.cos(theta), math.sin(-theta), 0],
                     [math.sin(theta), math.cos(theta), 0],
                     [0, 0, 1]], np.float64)


class KarrasAugmentationPipeline:
    """EDM affine augmentation (ref: k_diffusion/augmentation.py:34-86;
    `kdip_tpu` data.py:282-349) on [C, H, W] images.

    __call__(image, rng) -> (aug, orig, cond9), images in [-1, 1]; an
    image with no negative value is taken as [0, 1]. The RandomState draws,
    their order and the 9-dim cond vector are `kdip_tpu`'s: [a0, a1, a2,
    cos(a3)-1, sin(a3), a5 cos(a4), a5 sin(a4), a6, a7].
    """

    def __init__(self, a_prob=0.12, a_scale=2 ** 0.2, a_aniso=2 ** 0.2,
                 a_trans=1 / 8):
        self.a_prob = a_prob
        self.a_scale = a_scale
        self.a_aniso = a_aniso
        self.a_trans = a_trans

    def __call__(self, image: np.ndarray,
                 rng: Optional[np.random.RandomState] = None):
        if rng is None:
            rng = np.random.RandomState()
        if image.ndim == 2:
            image = image[None]
        h, w = image.shape[1:]
        mats = [_translate2d(h / 2 - 0.5, w / 2 - 0.5)]

        a0 = float(rng.randint(2))
        mats.append(_scale2d(1 - 2 * a0, 1))
        a1 = float(rng.randint(2)) * float(rng.rand() < self.a_prob)
        mats.append(_scale2d(1, 1 - 2 * a1))
        a2 = float(rng.randn()) * float(rng.rand() < self.a_prob)
        mats.append(_scale2d(self.a_scale ** a2, self.a_scale ** a2))
        a3 = float(rng.rand() * 2 * math.pi - math.pi) * float(
            rng.rand() < self.a_prob)
        mats.append(_rotate2d(-a3))
        do4 = float(rng.rand() < self.a_prob)
        a4 = float(rng.rand() * 2 * math.pi - math.pi) * do4
        a5 = float(rng.randn()) * do4
        mats.append(_rotate2d(a4))
        mats.append(_scale2d(self.a_aniso ** a5, self.a_aniso ** -a5))
        mats.append(_rotate2d(-a4))
        do6 = float(rng.rand() < self.a_prob)
        a6 = float(rng.randn()) * do6
        a7 = float(rng.randn()) * do6
        mats.append(_translate2d(self.a_trans * w * a6, self.a_trans * h * a7))

        mats.append(_translate2d(-h / 2 + 0.5, -w / 2 + 0.5))
        mat = reduce(np.matmul, mats)
        cond = np.array([a0, a1, a2, math.cos(a3) - 1, math.sin(a3),
                         a5 * math.cos(a4), a5 * math.sin(a4), a6, a7],
                        np.float32)

        image01 = (image + 1) / 2 if image.min() < 0 else image
        aug = self._warp(image01, mat)
        orig = image01 * 2 - 1
        aug = aug * 2 - 1
        return aug.astype(np.float32), orig.astype(np.float32), cond

    @staticmethod
    def _warp(image01: np.ndarray, mat: np.ndarray) -> np.ndarray:
        """Affine warp of each channel plane, cubic with reflect boundary
        (ref: augmentation.py:82-83 skimage.transform.warp order=3
        mode='reflect'), through scipy.ndimage as `kdip_tpu` does: mat acts
        on (x, y, 1) = (col, row, 1); the output samples mat^-1, swapped
        to (row, col)."""
        from scipy import ndimage
        inv = np.linalg.inv(mat)
        swap = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
        m_rc = swap @ inv @ swap
        out = np.empty_like(image01)
        for c in range(image01.shape[0]):
            out[c] = ndimage.affine_transform(
                image01[c], m_rc[:2, :2], offset=m_rc[:2, 2], order=3,
                mode="reflect", prefilter=True)
        return out


def augment_batch(pipeline: KarrasAugmentationPipeline, images: np.ndarray,
                  seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The augmentation of each image of a [B, C, H, W] batch, image i
    drawn from RandomState((seed * 100003 + i) % 2^31)."""
    augs, origs, conds = [], [], []
    for i, img in enumerate(images):
        rng = np.random.RandomState((seed * 100003 + i) % (2 ** 31))
        a, o, c = pipeline(img, rng)
        augs.append(a)
        origs.append(o)
        conds.append(c)
    return np.stack(augs), np.stack(origs), np.stack(conds)
