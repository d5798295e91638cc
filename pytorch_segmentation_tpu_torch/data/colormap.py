"""VOC bit-twiddle color palette (copy of
pytorch_segmentation_tpu/data/colormap.py, numpy only).

Kept in BGR order like the JAX package; the port's PNG writer takes RGB, so
callers reverse the last axis before encoding a colorized mask.
"""

from __future__ import annotations

import numpy as np

__all__ = ["voc_colormap", "VOC_COLORMAP", "colorize_mask"]


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
