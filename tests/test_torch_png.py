"""PyTorch port: the stdlib-zlib PNG codec the port's server uses in place
of OpenCV, so a GPU serving host needs no OpenCV. OpenCV is the reference
here."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu_torch.utils.png import decode_png, encode_png

torch.set_num_threads(1)


def _image(channels, seed, hw=(23, 31)):
    rng = np.random.default_rng(seed)
    shape = hw if channels == 1 else (*hw, channels)
    # a smooth ramp plus noise, so every filter type sees real structure
    ramp = np.add.outer(np.arange(hw[0]), 3 * np.arange(hw[1]))
    if channels > 1:
        ramp = ramp[:, :, None]
    return ((ramp + rng.integers(0, 60, shape)) % 256).astype(np.uint8)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode_filtered(img, filter_type):
    """A PNG of uint8 `img` with every row filtered with `filter_type` 1..4,
    written byte by byte from the PNG specification (section 9)."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * bpp).astype(int)
    rows = bytearray()
    for y in range(h):
        rows.append(filter_type)
        for i in range(w * bpp):
            a = x[y, i - bpp] if i >= bpp else 0
            b = x[y - 1, i] if y > 0 else 0
            c = x[y - 1, i - bpp] if y > 0 and i >= bpp else 0
            if filter_type == 1:
                pred = a
            elif filter_type == 2:
                pred = b
            elif filter_type == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            rows.append((x[y, i] - pred) & 255)
    color = {1: 0, 3: 2, 4: 6}[bpp]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(rows)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(filter_type, channels):
    """Filter 0 is what encode_png writes; 1..4 are written here."""
    img = _image(channels, seed=filter_type * 10 + channels)
    data = (encode_png(img) if filter_type == 0
            else _encode_filtered(img, filter_type))
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.array_equal(got, img)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_cv2_files(channels):
    """OpenCV (libpng) picks filters per row adaptively; the decode must be
    identical to OpenCV's own, with its BGR(A) order reversed."""
    img = _image(channels, seed=channels, hw=(37, 29))
    for level in (1, 9):
        ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION,
                                             level])
        assert ok
        want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        if channels > 1:
            want = want[:, :, ::-1] if channels == 3 else \
                want[:, :, [2, 1, 0, 3]]
        got = decode_png(buf.tobytes())
        assert np.array_equal(got, want)
        # and OpenCV reads what the port writes
        back = cv2.imdecode(np.frombuffer(encode_png(got), np.uint8),
                            cv2.IMREAD_UNCHANGED)
        assert np.array_equal(back, cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))


def test_png_rejects_what_it_cannot_read():
    ok, jpg = cv2.imencode(".jpg", _image(3, 0))
    assert ok
    with pytest.raises(ValueError, match="JPEG"):
        decode_png(jpg.tobytes())
    with pytest.raises(ValueError):
        decode_png(b"this is not an image")
    good = encode_png(_image(3, 1))
    with pytest.raises(ValueError):
        decode_png(good[:-20])  # truncated
    corrupt = bytearray(good)
    corrupt[40] ^= 0xFF  # inside IDAT: the chunk CRC no longer matches
    with pytest.raises(ValueError):
        decode_png(bytes(corrupt))
    ok, png16 = cv2.imencode(".png", _image(3, 2).astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(png16.tobytes())
