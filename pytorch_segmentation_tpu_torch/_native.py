"""ctypes binding of the host-side data kernels in `csrc/pseg_native.cpp`
(the polygon fill and the colour map; port of pytorch_segmentation_tpu/
_native.py).

`g++` builds the source at the first call of `lib()`, never at import, into
`build/native/` at the root of the checkout (listed in `.gitignore`), under
a name that carries a hash of the source and the flags. A failed build
raises: the datasets have no silent fallback. The numpy versions in
`data/rasterize.py` and `data/colormap.py` are the plain versions the tests
hold these against.
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

__all__ = ["lib", "library_path", "NativeLib", "BUILD_DIR", "CXX_FLAGS"]

_PKG_DIR = Path(__file__).resolve().parent
_SRC = _PKG_DIR / "csrc" / "pseg_native.cpp"
BUILD_DIR = _PKG_DIR.parent / "build" / "native"
# no contraction of a * b + c into one FMA, where the target has it: the
# numpy versions round each operation
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
             "-ffp-contract=off")

_lock = threading.Lock()
_loaded: list = []


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"pseg_native-{digest[:16]}.so"


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

    @staticmethod
    def _u8(a: np.ndarray):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

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
        self._c.fill_polygon(self._u8(mask), mask.shape[0], mask.shape[1],
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
        self._c.map_colors(self._u8(color_img), color_img.shape[0],
                           color_img.shape[1], self._u8(colormap),
                           len(colormap), self._u8(out))
        return out


def lib() -> NativeLib:
    """The library, built with g++ on first use; raises if it cannot be."""
    with _lock:
        if _loaded:
            return _loaded[0]
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except OSError as e:
                os.unlink(tmp)
                raise RuntimeError(f"cannot run g++ to build {_SRC.name}: "
                                   f"{e}") from None
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed for {_SRC.name} (exit "
                                   f"{proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        _loaded.append(NativeLib(path))
        return _loaded[0]
