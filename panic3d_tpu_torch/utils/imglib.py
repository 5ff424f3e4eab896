"""Minimal functional image type (panic3d_tpu/utils/imglib.py), with a PNG
codec of its own.

``Img`` holds a numpy float32 CHW image in [0, 1] (1, 3 or 4 channels):
load, convert, background-composite, alpha, crop, save. The JAX package
reads and writes files through Pillow; the port does not depend on it, so
PNG goes through the standard library here: 8-bit greyscale, RGB and RGBA,
non-interlaced, all five row filters on reading (zlib + struct). Any other
PNG raises. ``resize`` needs Pillow and raises without it (no path of the
port calls it).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Union

import numpy as np

_BG_COLORS = {
    "w": (1.0, 1.0, 1.0),
    "k": (0.0, 0.0, 0.0),
}

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {0: 1, 2: 3, 6: 4}        # PNG colour type -> channels
_TYPE_OF_CHANNELS = {1: 0, 3: 2, 4: 6}


class Img:
    """Immutable CHW float image with chainable ops."""

    def __init__(self, data):
        if isinstance(data, Img):
            self.data = data.data
            return
        if isinstance(data, str):
            data = read_png(data)
        data = np.asarray(data)
        if data.dtype == np.uint8:
            data = data.astype(np.float32) / 255.0
        if data.ndim == 2:
            data = data[None]
        if data.ndim == 3 and data.shape[-1] in (1, 3, 4) and data.shape[0] not in (1, 3, 4):
            data = data.transpose(2, 0, 1)  # HWC -> CHW
        if data.ndim == 4:
            data = data[0]
        assert data.ndim == 3 and data.shape[0] in (1, 3, 4), data.shape
        self.data = np.clip(data.astype(np.float32), 0.0, 1.0)

    @property
    def size(self):
        return self.data.shape[-1]

    @property
    def channels(self):
        return self.data.shape[0]

    def t(self) -> np.ndarray:
        """CHW float32 array (the reference's .t() tensor accessor)."""
        return self.data

    def convert(self, mode: str) -> "Img":
        c = self.channels
        if mode == "RGB":
            if c == 3:
                return self
            if c == 4:
                return Img(self.data[:3])
            if c == 1:
                return Img(np.repeat(self.data, 3, axis=0))
        if mode == "RGBA":
            if c == 4:
                return self
            if c == 3:
                a = np.ones_like(self.data[:1])
                return Img(np.concatenate([self.data, a], axis=0))
            if c == 1:
                rgb = np.repeat(self.data, 3, axis=0)
                return Img(np.concatenate([rgb, np.ones_like(self.data[:1])], axis=0))
        if mode in ("L", "A"):
            if c == 1:
                return self
            if c >= 3:
                lum = (
                    0.299 * self.data[0] + 0.587 * self.data[1] + 0.114 * self.data[2]
                )
                return Img(lum[None])
        raise ValueError(mode)

    def bg(self, color: Union[str, tuple] = "w") -> "Img":
        """Composite over a solid background (twodee_v1.py:533)."""
        if self.channels != 4:
            return self
        rgb, a = self.data[:3], self.data[3:4]
        c = np.asarray(_BG_COLORS.get(color, color), dtype=np.float32)[:, None, None]
        out = rgb * a + c * (1 - a)
        return Img(np.concatenate([out, np.ones_like(a)], axis=0))

    def alpha(self) -> np.ndarray:
        if self.channels == 4:
            return self.data[3:4]
        return np.ones_like(self.data[:1])

    def resize(self, size: int, mode: str = "bilinear") -> "Img":
        """Pillow's LANCZOS (downscaling, or mode 'lanczos') or BILINEAR
        resize, as the JAX package's; raises where Pillow is not installed."""
        if self.size == size and self.data.shape[-2] == size:
            return self
        from PIL import Image

        resample = (Image.Resampling.LANCZOS if mode == "lanczos" or self.size > size
                    else Image.Resampling.BILINEAR)
        arr = self.numpy_uint8().transpose(1, 2, 0)
        pil = Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr)
        return Img(np.asarray(pil.resize((size, size), resample)))

    def crop(self, left, top, right, bottom) -> "Img":
        return Img(self.data[:, top:bottom, left:right])

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_png(path, self.numpy_uint8())
        return self

    def numpy_uint8(self) -> np.ndarray:
        return (self.data * 255).round().astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, chw: np.ndarray, level: int = 1) -> None:
    """Write a uint8 CHW array (1, 3 or 4 channels) as an 8-bit PNG, every
    row with filter 0 (none), zlib at ``level``."""
    c, h, w = chw.shape
    rows = np.ascontiguousarray(chw.transpose(1, 2, 0)).reshape(h, w * c)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, _TYPE_OF_CHANNELS[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (none, sub, up, average, Paeth) -> [h, stride]
    uint8. Sub and up are vectorised; average and Paeth depend on the pixel
    to their left, so they run a pixel at a time."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError("PNG: image data of the wrong size")
    buf = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ft, row = buf[y, 0], buf[y, 1:].astype(np.int64)
        if ft == 0:
            cur = row
        elif ft == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ft == 2:
            cur = (row + prior) & 0xFF
        elif ft in (3, 4):
            cur = row.copy()
            left = np.zeros(bpp, np.int64)
            up_left = np.zeros(bpp, np.int64)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                pred = (left + up) // 2 if ft == 3 else _paeth(left, up, up_left)
                left = (cur[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG: unknown row filter {ft}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit greyscale, RGB or RGBA non-interlaced PNG -> uint8 HWC
    array (HW for greyscale); raises on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    off, idat, header = 8, [], None
    while off < len(data):
        (n,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        off += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _COLOR_TYPES or interlace != 0:
        raise ValueError(f"{path}: only 8-bit greyscale, RGB or RGBA non-interlaced PNG is "
                         f"read (bit depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _COLOR_TYPES[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c).reshape(h, w, c)
    return pix[..., 0] if c == 1 else pix


def from_model_output(x, normalize=True) -> Img:
    """[-1,1] (or [0,1]) CHW array -> Img."""
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    if normalize:
        x = x * 0.5 + 0.5
    return Img(np.clip(x, 0, 1))
