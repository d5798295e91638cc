"""`imread` and `imdecode` for every caller of the port, as OpenCV's
imgcodecs gives them to the JAX package: the format is read from the bytes'
signature, not the file's suffix, PNG going to `utils/png` and JPEG to
`utils/jpeg`.

IMREAD_COLOR gives BGR uint8 [H, W, 3] (gray repeated, alpha dropped);
IMREAD_GRAYSCALE uint8 [H, W] (a colour PNG through libpng's weights, a
colour JPEG as its Y plane, each as cv2 reads it). Unlike cv2, whatever is
not read raises (OSError, ValueError) instead of returning None.
"""

from __future__ import annotations

import numpy as np

from .jpeg import IMREAD_COLOR, IMREAD_GRAYSCALE, decode_jpeg
from .png import decode_png

__all__ = ["imread", "imdecode", "IMREAD_COLOR", "IMREAD_GRAYSCALE"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# libpng's RGB -> gray weights over 2^15 (truncated sums): what
# cv2.imread(..., IMREAD_GRAYSCALE) gives for a colour PNG
_GRAY_WEIGHTS = (9797, 19234, 3737)  # R, G, B


def _png_as(img: np.ndarray, flags: int) -> np.ndarray:
    """A decoded PNG (gray, gray + alpha, RGB, RGBA) as cv2 gives it."""
    if img.ndim == 3 and img.shape[2] == 2:
        img = img[:, :, 0]  # gray + alpha: the alpha is dropped
    if flags == IMREAD_GRAYSCALE:
        if img.ndim == 2:
            return img
        rgb = img[:, :, :3].astype(np.uint32)
        gray = sum(rgb[:, :, i] * wt for i, wt in enumerate(_GRAY_WEIGHTS))
        return (gray >> 15).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def imdecode(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """What `cv2.imdecode(np.frombuffer(data, np.uint8), flags)` returns for
    a PNG or JPEG body (IMREAD_COLOR or IMREAD_GRAYSCALE)."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"imdecode: flags {flags}: IMREAD_COLOR or "
                         "IMREAD_GRAYSCALE only")
    data = bytes(data)
    if data[:8] == _PNG_SIGNATURE:
        return _png_as(decode_png(data), flags)
    if data[:3] == _JPEG_SIGNATURE:
        return decode_jpeg(data, flags)
    raise ValueError("not a PNG or JPEG image")


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """What `cv2.imread(path, flags)` returns for a PNG or JPEG file."""
    with open(path, "rb") as f:
        return imdecode(f.read(), flags)
