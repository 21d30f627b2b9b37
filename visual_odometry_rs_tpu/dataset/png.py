"""PNG codec in numpy + zlib: the dependency-free fallback of the native loader.

Covers what TUM RGB-D sequences use: non-interlaced 8-bit gray, gray+alpha,
RGB and RGBA, and 16-bit gray (depth maps), with all five row filters
(none, sub, up, average, Paeth).  Palette and interlaced images are refused
with ``ValueError``.  Decoding of rows filtered with none/sub/up is
vectorised; average and Paeth rows depend on the pixel just decoded and
run a per-byte loop.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if ftype == 0:
        return raw
    if ftype == 1:
        per_px = raw.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(per_px, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if ftype == 2:
        return raw + prev  # uint8 arithmetic wraps mod 256
    if ftype not in (3, 4):
        raise ValueError(f"invalid PNG filter type {ftype}")
    out = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            pred = (a + up[i]) >> 1
        else:
            pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) array, uint8 or uint16."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace})"
        )
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        prev = out[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:], prev, bpp)
    if depth == 16:
        img = out.view(">u2").astype(np.uint16)
    else:
        img = out
    img = img.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def _filter_rows(img_bytes: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Apply one filter type to every row of an (H, stride) uint8 array."""
    x = img_bytes.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"invalid PNG filter type {ftype}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode(img: np.ndarray, filter_type: int = 0, level: int = 6) -> bytes:
    """(H, W[, C]) uint8 or (H, W) uint16 array -> PNG bytes.

    Every row gets ``filter_type`` (0 = none, the fastest to decode).
    """
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
        data = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and img.ndim in (2, 3):
        depth = 8
        channels = 1 if img.ndim == 2 else img.shape[2]
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
        data = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot encode a {img.dtype} array of shape {img.shape}")
    height, width = img.shape[:2]
    bpp = _CHANNELS[ctype] * depth // 8
    filtered = _filter_rows(data, bpp, filter_type)
    scan = np.concatenate(
        [np.full((height, 1), filter_type, np.uint8), filtered], axis=1
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (
        _SIGNATURE
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(scan.tobytes(), level))
        + chunk(b"IEND", b"")
    )


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def write(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, filter_type))
