"""A small PNG codec on the standard library's zlib and numpy.

The serving path decodes PNG request bodies and encodes masks with it, and
`utils/imgcodecs.imread` hands it the datasets' PNG files, so a GPU host
needs no OpenCV. Read: grayscale at bit depths 1, 2, 4 and 8, palette at 1,
2, 4 and 8, grayscale + alpha, RGB and RGBA at 8, non-interlaced, all five
row filter types. Anything else (16-bit, interlaced, JPEG bytes, which go to
`utils/jpeg`) raises ValueError, which the server answers with a 400.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel, bit depths read
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
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
    """Rows [h, 1 + w * bpp] (filter type byte first) -> the reconstructed
    bytes [h, w, bpp]; `bpp` is the filter unit, at least one byte."""
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


def _unpack(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """Bytes [h, row_bytes] of `depth`-bit samples (1, 2 or 4; the first
    sample in the highest bits) -> uint8 samples [h, w]."""
    bits = np.unpackbits(rows, axis=1)[:, :w * depth]
    bits = bits.reshape(rows.shape[0], w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray), [H, W, 2] (gray + alpha),
    [H, W, 3] (RGB; a palette image is looked up) or [H, W, 4] (RGBA).
    Gray below 8 bits is scaled to 0..255 as libpng expands it. Raises
    ValueError on anything this codec does not read."""
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError("JPEG bytes, not PNG: utils/jpeg.decode_jpeg (or "
                         "utils/imgcodecs.imdecode) reads them")
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG image")
    pos, header, idat, palette = 8, None, [], None
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
        elif kind == b"PLTE":
            if length % 3 or not 0 < length <= 768:
                raise ValueError("malformed PNG palette")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = header
    if (color not in _CHANNELS or depth not in _DEPTHS[color]
            or interlace != 0):
        raise ValueError(f"unsupported PNG (bit depth {depth}, color type "
                         f"{color}, interlace {interlace}); non-interlaced "
                         "gray or palette at 1-8 bits, gray+alpha, RGB or "
                         "RGBA at 8 bits only")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    if not (0 < w and 0 < h and w * h <= _MAX_PIXELS):
        raise ValueError(f"PNG size {w}x{h} out of range")
    channels = _CHANNELS[color]
    row_bytes = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)  # the filters' unit
    expected = h * (1 + row_bytes)
    try:
        inflater = zlib.decompressobj()
        buf = inflater.decompress(b"".join(idat), expected)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    if len(buf) != expected:
        raise ValueError("PNG image data has the wrong size")
    raw = np.frombuffer(buf, np.uint8).reshape(h, 1 + row_bytes)
    img = _unfilter(raw, h, row_bytes // bpp, bpp).reshape(h, row_bytes)
    if depth < 8:
        img = _unpack(img, w, depth)
        if color == 0:
            img = img * np.uint8(255 // (2 ** depth - 1))
    if color == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[img]
    img = img.reshape(h, w, channels)
    return img[:, :, 0] if channels == 1 else img

