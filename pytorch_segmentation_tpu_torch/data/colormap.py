"""VOC bit-twiddle color palette and the colour -> class-id map (port of
pytorch_segmentation_tpu/data/colormap.py without OpenCV).

Kept in BGR order like the JAX package; the port's PNG writer takes RGB, so
callers reverse the last axis before encoding a colorized mask.
`mask_from_colors` runs the native colour map (`csrc/pseg_native.cpp`);
`mask_from_colors_reference` is its plain numpy version.
"""

from __future__ import annotations

import numpy as np

from .._native import lib as _native

__all__ = ["voc_colormap", "VOC_COLORMAP", "colorize_mask",
           "mask_from_colors", "mask_from_colors_reference"]


def voc_colormap(n: int = 256) -> np.ndarray:
    """[n, 3] uint8 palette, BGR order."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (b, g, r)
    return cmap


VOC_COLORMAP = voc_colormap(32)


def colorize_mask(mask: np.ndarray, colormap: np.ndarray = VOC_COLORMAP) -> np.ndarray:
    """Class-id mask [H, W] -> BGR color image [H, W, 3] (table lookup;
    ids outside the palette map to black)."""
    mask = np.asarray(mask)
    n = len(colormap)
    safe = np.clip(mask, 0, n - 1).astype(np.int64)
    out = colormap[safe]
    out[mask >= n] = 0
    return out.astype(np.uint8)


def mask_from_colors(color_img: np.ndarray,
                     colormap: np.ndarray) -> np.ndarray:
    """BGR color label image [H, W, 3] -> class-id mask [H, W] uint8: the
    pixels of colour `colormap[i]` get id i (the last of equal colours
    wins), unmatched colours 0."""
    return _native().map_colors(color_img, colormap)


def mask_from_colors_reference(color_img: np.ndarray,
                               colormap: np.ndarray) -> np.ndarray:
    """The plain version of `mask_from_colors`: one pass per colour."""
    color_img = np.asarray(color_img, dtype=np.uint8)
    mask = np.zeros(color_img.shape[:2], dtype=np.uint8)
    for ci, c in enumerate(np.asarray(colormap, np.uint8)):
        mask[(color_img == c).all(axis=2)] = ci
    return mask
