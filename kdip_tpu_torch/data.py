"""The test-image folder and the port's PNG codec (PyTorch port of
`kdip_tpu/data.py:27-56`; ref: k_diffusion/utils.py:274-297).

`FolderOfImages` is a sorted recursive glob that returns `(arr,)`, arr a
float32 [C, H, W] array in [-1, 1]. The card's machine has no PIL, so an
8-bit non-interlaced PNG of colour type 0, 2, 4 or 6 (grey, RGB, grey +
alpha, RGBA) is decoded here: zlib, the five PNG row filters and numpy,
the counterpart of the PNG path of `kdip_tpu`'s native loader
(`kdip_tpu/native/loader.cc`). Every other file, and every file under
`size=`, goes through PIL as `kdip_tpu` reads it; the choice is made from
the extension and the PNG header. `write_png` writes the CLI's 8-bit RGB
PNGs.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Callable, Optional, Tuple

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
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (1 + stride)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:      # None
            cur = line
        elif ftype == 1:    # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            cur = line + prev
        elif ftype == 3:
            cur = _unfilter_average(line.tobytes(), prev.tobytes(), bpp)
        elif ftype == 4:
            cur = _unfilter_paeth(line.tobytes(), prev.tobytes(), bpp)
        else:
            raise ValueError(f"{path}: row {y} has filter type {ftype}")
        out[y] = cur
        prev = out[y]
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


class FolderOfImages:
    """Recursive image folder dataset, no classes
    (ref: k_diffusion/utils.py:274-297). Returns float32 [C, H, W] arrays
    in [-1, 1]; `transform` is applied to that array."""

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
        if self.size is None and decodes_natively(path):
            return _rgb(read_png(path))
        from PIL import Image
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.size is not None:
                img = img.resize((self.size, self.size), Image.LANCZOS)
            return np.asarray(img)

    def __getitem__(self, idx) -> Tuple[np.ndarray]:
        arr = self._uint8_rgb(self.paths[idx]).astype(np.float32) / 255.0
        arr = np.ascontiguousarray((arr * 2 - 1).transpose(2, 0, 1))
        if self.transform is not None:
            arr = self.transform(arr)
        return (arr,)
