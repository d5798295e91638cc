"""ctypes bindings of the port's host-side C++ sources: the polygon fill and
the colour map in `csrc/pseg_native.cpp` (port of pytorch_segmentation_tpu/
_native.py), and the JPEG codec in `csrc/jpeg_codec.cpp` (what the JAX
package gets from OpenCV).

`g++` builds each source at the first call of its loader (`lib()`,
`jpeg_lib()`), never at import, into `build/native/` at the root of the
checkout (listed in `.gitignore`), under a name that carries a hash of the
source and the flags, one library per source: a change to the codec does not
rebuild the polygon fill. A failed build raises: neither has a silent
fallback. The numpy versions in `data/rasterize.py` and `data/colormap.py`
are the plain versions the tests hold the first against; OpenCV is the
codec's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["lib", "jpeg_lib", "library_path", "NativeLib", "JpegLib",
           "JpegError", "BUILD_DIR", "CXX_FLAGS", "JPEG_CXX_FLAGS"]

_PKG_DIR = Path(__file__).resolve().parent
_SRC = _PKG_DIR / "csrc" / "pseg_native.cpp"
_JPEG_SRC = _PKG_DIR / "csrc" / "jpeg_codec.cpp"
BUILD_DIR = _PKG_DIR.parent / "build" / "native"
# no contraction of a * b + c into one FMA, where the target has it: the
# numpy versions round each operation
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
             "-ffp-contract=off")
# integer arithmetic only; no OpenMP: loader and request threads call it at
# once
JPEG_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict = {}


def library_path(src: Path = _SRC, flags=CXX_FLAGS) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def _build(src: Path, flags) -> Path:
    """The library of `src`, compiled with g++ unless it is on disk; the
    file appears whole or not at all (written aside, then renamed)."""
    path = library_path(src, flags)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags, str(src), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++ to build {src.name}: {e}"
                           ) from None
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {src.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load(key, src, flags, cls):
    with _lock:
        if key not in _loaded:
            _loaded[key] = cls(_build(src, flags))
        return _loaded[key]


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeLib:
    """The loaded library, with numpy-facing calls that check their
    arguments before any pointer is passed."""

    def __init__(self, path: Path):
        self._c = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i = ctypes.c_int
        self._c.fill_polygon.argtypes = [u8p, i, i, f32p, i, ctypes.c_uint8]
        self._c.fill_polygon.restype = None
        self._c.map_colors.argtypes = [u8p, i, i, u8p, i, u8p]
        self._c.map_colors.restype = None

    def fill_polygon(self, mask: np.ndarray, points: np.ndarray,
                     value: int) -> None:
        """Fill `points` [N, 2] (x, y) into the C-contiguous uint8 `mask`
        [H, W] in place."""
        if (mask.dtype != np.uint8 or mask.ndim != 2
                or not mask.flags.c_contiguous or not mask.flags.writeable):
            raise ValueError("fill_polygon needs a writeable C-contiguous "
                             "uint8 [H, W] mask")
        pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 2)
        f32p = pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._c.fill_polygon(_u8(mask), mask.shape[0], mask.shape[1],
                             f32p, len(pts), int(value) & 0xFF)

    def map_colors(self, color_img: np.ndarray,
                   colormap: np.ndarray) -> np.ndarray:
        """uint8 [H, W, 3] colours -> uint8 [H, W] ids (see the source)."""
        color_img = np.ascontiguousarray(color_img, dtype=np.uint8)
        colormap = np.ascontiguousarray(colormap, dtype=np.uint8)
        if color_img.ndim != 3 or color_img.shape[2] != 3:
            raise ValueError(f"map_colors needs [H, W, 3] colours, got "
                             f"{color_img.shape}")
        if colormap.ndim != 2 or colormap.shape[1] != 3:
            raise ValueError(f"map_colors needs a [N, 3] colormap, got "
                             f"{colormap.shape}")
        out = np.zeros(color_img.shape[:2], dtype=np.uint8)
        self._c.map_colors(_u8(color_img), color_img.shape[0],
                           color_img.shape[1], _u8(colormap),
                           len(colormap), _u8(out))
        return out


class JpegError(ValueError):
    """A JPEG the codec does not read: `code` is the source's error code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


# the codec's error codes (csrc/jpeg_codec.cpp) and what they say
JPEG_ERRORS = {
    -1: "not a JPEG image (no SOI marker)",
    -2: "truncated JPEG: the data ends before the image does",
    -3: "corrupt JPEG data",
    -4: "arithmetic-coded JPEG is not read (Huffman only)",
    -5: "12-bit, lossless or hierarchical JPEG is not read (8-bit "
        "sequential or progressive only)",
    -6: "JPEG with other than 1 or 3 components (CMYK, YCCK) is not read",
    -7: "JPEG larger than 2^26 pixels",
    -8: "JPEG sampling factors that are not integer ratios",
    -9: "progressive JPEG whose scans leave coefficients incomplete",
    -10: "JPEG decode: buffer does not match the frame",
    -11: "out of memory decoding a JPEG",
    -12: "JPEG encode: output buffer too small",
}


class JpegLib:
    """The loaded codec, with numpy-facing calls that check their arguments
    before any pointer is passed; ctypes drops the GIL around each call."""

    def __init__(self, path: Path):
        self._c = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        i, sz = ctypes.c_int, ctypes.c_size_t
        self._c.pseg_jpeg_header.argtypes = [ctypes.c_char_p, sz, ip, ip]
        self._c.pseg_jpeg_header.restype = i
        self._c.pseg_jpeg_decode.argtypes = [ctypes.c_char_p, sz, i, u8p, i,
                                             i]
        self._c.pseg_jpeg_decode.restype = i
        self._c.pseg_jpeg_encode_bound.argtypes = [i, i, i]
        self._c.pseg_jpeg_encode_bound.restype = sz
        self._c.pseg_jpeg_encode.argtypes = [u8p, i, i, i, i, u8p, sz,
                                             ctypes.POINTER(sz)]
        self._c.pseg_jpeg_encode.restype = i

    @staticmethod
    def _check(rc: int) -> None:
        if rc:
            raise JpegError(rc, JPEG_ERRORS.get(rc, f"JPEG error {rc}"))

    def decode(self, data: bytes, gray: bool) -> np.ndarray:
        """JPEG bytes -> uint8 [H, W, 3] BGR or [H, W] gray, before any
        EXIF orientation."""
        data = bytes(data)
        w, h = ctypes.c_int(), ctypes.c_int()
        self._check(self._c.pseg_jpeg_header(data, len(data), ctypes.byref(w),
                                             ctypes.byref(h)))
        out = np.empty((h.value, w.value) + (() if gray else (3,)), np.uint8)
        self._check(self._c.pseg_jpeg_decode(data, len(data), int(gray),
                                             _u8(out), w.value, h.value))
        return out

    def encode(self, img: np.ndarray, quality: int) -> bytes:
        """uint8 [H, W] gray or [H, W, 3] BGR -> baseline JPEG bytes."""
        img = np.ascontiguousarray(img)
        if img.dtype != np.uint8 or not (
                img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
            raise ValueError(f"encode_jpeg takes uint8 [H, W] or [H, W, 3], "
                             f"not {img.dtype} {img.shape}")
        h, w = img.shape[:2]
        if not (0 < h <= 65535 and 0 < w <= 65535):
            raise ValueError(f"encode_jpeg: size {w}x{h} out of range")
        channels = 1 if img.ndim == 2 else 3
        cap = self._c.pseg_jpeg_encode_bound(w, h, channels)
        out = np.empty(cap, np.uint8)
        written = ctypes.c_size_t()
        self._check(self._c.pseg_jpeg_encode(_u8(img), w, h, channels,
                                             int(quality), _u8(out), cap,
                                             ctypes.byref(written)))
        return out[:written.value].tobytes()


def lib() -> NativeLib:
    """The polygon fill and colour map, built with g++ on first use; raises
    if it cannot be."""
    return _load("native", _SRC, CXX_FLAGS, NativeLib)


def jpeg_lib() -> JpegLib:
    """The JPEG codec, built with g++ on first use; raises if it cannot
    be."""
    return _load("jpeg", _JPEG_SRC, JPEG_CXX_FLAGS, JpegLib)
