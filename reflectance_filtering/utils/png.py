"""A small PNG codec on the standard library's zlib.

utils.image reads and writes through OpenCV where it is installed and
through this module where it is not, so the decompose and filter paths
need nothing beyond numpy.  Scope: 8-bit gray, RGB and RGBA (colour types
0, 2 and 6), non-interlaced.  Anything else raises ValueError naming what
it found.  Arrays are in the file's channel order (RGB/RGBA); utils.image
does the BGR swap of OpenCV's convention.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(image: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError("PNG encoder takes uint8, got {}".format(
            image.dtype))
    if image.ndim == 2:
        image = image[..., None]
    channels = image.shape[2] if image.ndim == 3 else 0
    ctype = {1: 0, 3: 2, 4: 6}.get(channels)
    if ctype is None:
        raise ValueError("PNG encoder takes [H, W] or [H, W, 1|3|4], got "
                         "shape {}".format(image.shape))
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),          # filter 0
                           image.reshape(h, w * channels)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9)."""
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:                                        # Sub
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:                                        # Up
            cur = line + prior
        elif ftype in (3, 4):                                   # Avg, Paeth
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError("PNG row {} has unknown filter {}".format(
                y, ftype))
        out[y] = cur
        prior = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            "unsupported PNG (bit depth {}, colour type {}, interlace {}): "
            "this codec reads 8-bit gray/RGB/RGBA, non-interlaced".format(
                depth, ctype, interlace))
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError("PNG data size {} does not match {}x{}x{}".format(
            raw.size, h, w, bpp))
    img = _unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp)
    return img[..., 0] if bpp == 1 else img


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def write(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(image))
