"""A small PNG codec on the standard library's zlib and numpy.

The serving path decodes request bodies and encodes masks with it, so a
GPU serving host needs no OpenCV. Supported: 8-bit grayscale, RGB and
RGBA, non-interlaced, all five row filter types. Anything else (including
JPEG) raises ValueError, which the server answers with a 400.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> bytes per pixel at 8 bits
_MAX_PIXELS = 1 << 26


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _predictors(a, b, c):
    """Predictions of filter types 1..4 from the left (a), up (b) and
    up-left (c) bytes."""
    return [a, b, (a + b) >> 1, _paeth(a, b, c)]


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG bytes,
    every row unfiltered (filter type 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, not {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}.get(channels) if img.ndim in (2, 3) else None
    if color is None:
        raise ValueError(f"encode_png: unsupported shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * channels), np.uint8)
    rows[:, 1:] = img.reshape(h, w * channels)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    types = raw[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError("PNG row filter type out of range")
    filt = raw[:, 1:].reshape(h, w, bpp)
    if types.max(initial=0) <= 2:
        # none / sub / up only: each row at once (sub is a running sum)
        out = np.empty_like(filt)
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            t = types[y]
            if t == 0:
                out[y] = filt[y]
            elif t == 1:
                out[y] = np.cumsum(filt[y], axis=0, dtype=np.uint8)
            else:
                out[y] = filt[y] + prev
            prev = out[y]
        return out
    # average / paeth depend on the reconstructed left, up and up-left
    # bytes: walk the anti-diagonals y + x = d, each of which depends only
    # on earlier ones, with every row's own filter applied at once
    rec = np.zeros((h + 1, w + 1, bpp), np.int16)  # zero row/column pad
    f16 = filt.astype(np.int16)
    t16 = types.astype(np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        t = t16[ys][:, None]
        pred = np.select([t == k for k in (1, 2, 3, 4)],
                         _predictors(a, b, c), 0)
        rec[ys + 1, xs + 1] = (f16[ys, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA). Raises ValueError on anything this codec does not read."""
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError("JPEG request bodies are not supported yet; "
                         "send PNG")
    if data[:8] != _SIGNATURE:
        raise ValueError("request body is not a PNG image")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError("malformed PNG header")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (bit depth {depth}, color type "
                         f"{color}, interlace {interlace}); 8-bit "
                         "gray/RGB/RGBA non-interlaced only")
    if not (0 < w and 0 < h and w * h <= _MAX_PIXELS):
        raise ValueError(f"PNG size {w}x{h} out of range")
    bpp = _CHANNELS[color]
    expected = h * (1 + w * bpp)
    try:
        inflater = zlib.decompressobj()
        buf = inflater.decompress(b"".join(idat), expected)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    if len(buf) != expected:
        raise ValueError("PNG image data has the wrong size")
    raw = np.frombuffer(buf, np.uint8).reshape(h, 1 + w * bpp)
    img = _unfilter(raw, h, w, bpp)
    return img[:, :, 0] if bpp == 1 else img
