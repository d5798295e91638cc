"""The JPEG fixtures of the port (tests/torch_jpeg_fixtures/), written with
OpenCV and PIL: small JPEGs over the decode matrix with cv2's colour and
gray decodes of each as PNG, encode sources with the bytes cv2 writes for
them, and files the codec must refuse, each with its error code.
`manifest.json` lists them. `chip_smoke.py` holds the port's codec against
them on a host without OpenCV; `tests/test_torch_jpeg.py` regenerates them
and requires the committed files byte for byte.

    python tests/torch_jpeg_util.py     # rewrite the committed fixtures
"""

from __future__ import annotations

import io
import json
import os
import struct

import cv2
import numpy as np
from PIL import Image

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_jpeg_fixtures")

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}

# the codec's error codes (csrc/jpeg_codec.cpp)
TRUNCATED, CORRUPT, ARITHMETIC, FRAME, COMPONENTS, TOO_LARGE, SAMPLING_BAD, \
    INCOMPLETE = -2, -3, -4, -5, -6, -7, -8, -9


def smooth_bgr(seed: int, h: int, w: int, gray: bool = False) -> np.ndarray:
    """A seeded image with edges and texture that still compresses: a 5x5
    random grid resized cubic, plus low noise."""
    rng = np.random.default_rng(seed)
    ch = 1 if gray else 3
    grid = rng.integers(0, 256, (5, 5, ch)).astype(np.float32)
    img = cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC)
    img = img.reshape(h, w, ch) + rng.normal(0, 3, (h, w, ch))
    img = img.clip(0, 255).astype(np.uint8)
    return img[:, :, 0] if gray else img


def cv2_jpeg(img: np.ndarray, quality: int = 95, sampling: str = "420",
             **flags) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    for key, value in flags.items():
        params += [{"progressive": cv2.IMWRITE_JPEG_PROGRESSIVE,
                    "restart": cv2.IMWRITE_JPEG_RST_INTERVAL,
                    "optimize": cv2.IMWRITE_JPEG_OPTIMIZE}[key], int(value)]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    """PIL's JPEG of a BGR or gray image (`keep_rgb=True` writes an Adobe
    APP14 with transform 0: RGB components)."""
    pil = Image.fromarray(img if img.ndim == 2 else img[:, :, ::-1])
    bio = io.BytesIO()
    pil.save(bio, "JPEG", **kw)
    return bio.getvalue()


def exif_jpeg(img: np.ndarray, orientation: int, big_endian=False) -> bytes:
    """A cv2 JPEG with an APP1 Exif segment holding one IFD entry, the
    orientation tag 0x0112 (TIFF byte order little or big endian)."""
    if big_endian:
        tiff = (b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1)
                + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
                + struct.pack(">I", 0))
    else:
        exif = Image.Exif()
        exif[0x0112] = orientation
        tiff = exif.tobytes()[6:]
    body = b"Exif\x00\x00" + tiff
    data = cv2_jpeg(img)
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + data[2:])


def cv2_decodes(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    return (cv2.imdecode(buf, cv2.IMREAD_COLOR),
            cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def png_bytes(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _segments(data: bytes):
    """(marker, start) of each marker before the first SOS's data."""
    pos, out = 2, []
    while pos + 4 <= len(data):
        marker = data[pos + 1]
        out.append((marker, pos))
        if marker == 0xDA:
            break
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return out


def _sof(data: bytes) -> int:
    return next(p for m, p in _segments(data) if m in (0xC0, 0xC1, 0xC2))


def decode_cases():
    """name -> JPEG bytes over the decode matrix."""
    cases = {}
    for name, (hw, q, samp, seed) in {
            "q95_420_37x53": ((37, 53), 95, "420", 1),
            "q30_444_49x35": ((49, 35), 30, "444", 2),
            "q75_422_7x13": ((7, 13), 75, "422", 3),
            "q100_440_16x16": ((16, 16), 100, "440", 4),
            "q95_411_49x35": ((49, 35), 95, "411", 5),
            "q95_420_1x1": ((1, 1), 95, "420", 6)}.items():
        cases[name] = cv2_jpeg(smooth_bgr(seed, *hw), q, samp)
    img = smooth_bgr(7, 37, 53)
    cases["progressive_420_37x53"] = cv2_jpeg(img, progressive=True)
    cases["progressive_444_pil_49x35"] = pil_jpeg(
        smooth_bgr(8, 49, 35), progressive=True, subsampling=0, quality=90)
    cases["restart3_422_49x35"] = cv2_jpeg(smooth_bgr(9, 49, 35), 90, "422",
                                           restart=3)
    cases["optimized_420_37x53"] = cv2_jpeg(img, 80, optimize=True)
    cases["gray_37x53"] = cv2_jpeg(smooth_bgr(10, 37, 53, gray=True))
    cases["adobe_rgb_37x53"] = pil_jpeg(smooth_bgr(11, 37, 53),
                                        keep_rgb=True, quality=90)
    small = smooth_bgr(12, 11, 19)
    for o in range(1, 9):
        cases[f"exif_orientation{o}_11x19"] = exif_jpeg(small, o,
                                                        big_endian=o == 6)
    return cases


def encode_cases():
    """name -> (source image, quality)."""
    return {"bgr_q95_37x53": (smooth_bgr(20, 37, 53), 95),
            "bgr_q50_49x35": (smooth_bgr(21, 49, 35), 50),
            "gray_q100_33x17": (smooth_bgr(22, 33, 17, gray=True), 100)}


def refuse_cases():
    """name -> (bytes, error code) the codec must refuse."""
    base = cv2_jpeg(smooth_bgr(30, 37, 53))
    sof = _sof(base)
    cases = {"truncated_half": (base[:len(base) // 2], TRUNCATED),
             "no_eoi": (base[:-2], TRUNCATED)}
    sof9 = bytearray(base)
    sof9[sof + 1] = 0xC9
    cases["arithmetic_sof9"] = (bytes(sof9), ARITHMETIC)
    prec = bytearray(base)
    prec[sof + 4] = 12
    cases["precision_12"] = (bytes(prec), FRAME)
    big = bytearray(base)
    big[sof + 5:sof + 9] = b"\xff\xff\xff\xff"
    cases["too_large"] = (bytes(big), TOO_LARGE)
    samp = bytearray(base)
    samp[sof + 11] = 0x31   # Y 3x1 and Cb 2x1: no integer ratio
    samp[sof + 14] = 0x21
    cases["sampling_3_2"] = (bytes(samp), SAMPLING_BAD)
    cases["reserved_marker"] = (base[:2] + b"\xff\xc8\x00\x04\x00\x00"
                                + base[2:], CORRUPT)
    dht = next(p for m, p in _segments(base) if m == 0xC4)
    bad = bytearray(base)
    bad[dht + 5] = 3        # three codes of length 1
    cases["huffman_overfull"] = (bytes(bad), CORRUPT)
    cmyk = Image.fromarray(smooth_bgr(31, 16, 24)).convert("CMYK")
    bio = io.BytesIO()
    cmyk.save(bio, "JPEG")
    cases["cmyk"] = (bio.getvalue(), COMPONENTS)
    prog = cv2_jpeg(smooth_bgr(32, 37, 53), progressive=True)
    last = [i for i in range(len(prog) - 1)
            if prog[i] == 0xFF and prog[i + 1] == 0xDA][-1]
    cases["progressive_missing_last_scan"] = (prog[:last] + b"\xff\xd9",
                                              INCOMPLETE)
    return cases


def write_fixtures(out_dir: str = FIXTURE_DIR) -> dict:
    """Write every fixture file and manifest.json into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    files = {}
    manifest = {"decode": [], "encode": [], "refuse": []}
    for name, data in decode_cases().items():
        color, gray = cv2_decodes(data)
        files[f"{name}.jpg"] = data
        files[f"{name}_color.png"] = png_bytes(color)
        files[f"{name}_gray.png"] = png_bytes(gray)
        manifest["decode"].append({"name": name, "jpeg": f"{name}.jpg",
                                   "color": f"{name}_color.png",
                                   "gray": f"{name}_gray.png",
                                   "shape": list(color.shape)})
    for name, (img, quality) in encode_cases().items():
        ok, buf = cv2.imencode(".jpg", img,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        files[f"enc_{name}.png"] = png_bytes(img)
        files[f"enc_{name}.jpg"] = buf.tobytes()
        manifest["encode"].append({"name": name,
                                   "source": f"enc_{name}.png",
                                   "quality": quality,
                                   "jpeg": f"enc_{name}.jpg"})
    for name, (data, code) in refuse_cases().items():
        files[f"bad_{name}.jpg"] = data
        manifest["refuse"].append({"name": name, "jpeg": f"bad_{name}.jpg",
                                   "code": code})
    files["manifest.json"] = (json.dumps(manifest, indent=1) + "\n").encode()
    for name, data in files.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
    return files


if __name__ == "__main__":
    written = write_fixtures()
    print(f"{len(written)} files, {sum(map(len, written.values()))} bytes "
          f"in {FIXTURE_DIR}")
