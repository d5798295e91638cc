"""Polygon -> class-id mask rasterization (port of
pytorch_segmentation_tpu/data/rasterize.py without OpenCV).

`fill_polygon` runs the native scanline fill (`csrc/pseg_native.cpp`
through `_native.lib()`, built with g++ at first use; a failed build
raises). `fill_polygon_reference` is its plain numpy version, with the same
float32 arithmetic in the same order, so the two fill the same pixels: an
even-odd scanline fill at integer pixel centres, then the outline, as
cv2.fillPoly draws it (points on a line from each vertex to the next, at
steps of at most one pixel, rounded half away from zero).
"""

from __future__ import annotations

import numpy as np

from .._native import lib as _native

__all__ = ["fill_polygon", "fill_polygon_reference", "rasterize_annotations"]


def fill_polygon(mask: np.ndarray, points: np.ndarray,
                 value: int) -> np.ndarray:
    """Fill one polygon into `mask` (uint8 [H, W], C-contiguous, in place)
    with `value`. points: [N, 2] (x, y); fewer than 3 fill nothing."""
    points = np.asarray(points).reshape(-1, 2)
    if len(points) >= 3:
        _native().fill_polygon(mask, points.astype(np.float32), int(value))
    return mask


def _lround(x: np.ndarray) -> np.ndarray:
    """C's lround of float32 values: half away from zero (exact in f64)."""
    x = x.astype(np.float64)
    return (np.sign(x) * np.floor(np.abs(x) + 0.5)).astype(np.int64)


def fill_polygon_reference(mask: np.ndarray, points: np.ndarray,
                           value: int) -> np.ndarray:
    """The plain version of `fill_polygon`: the native fill's float32
    arithmetic in numpy, vectorised over scanlines."""
    pts = np.asarray(points).reshape(-1, 2).astype(np.float32)
    n = len(pts)
    if n < 3:
        return mask
    value = int(value) & 0xFF
    h, w = mask.shape
    ax, ay = pts[:, 0], pts[:, 1]
    bx, by = np.roll(ax, -1), np.roll(ay, -1)
    y0 = max(0, int(np.floor(ay.min())))
    y1 = min(h - 1, int(np.ceil(ay.max())))
    if y0 <= y1:
        row = np.arange(y0, y1 + 1, dtype=np.float32)[:, None]
        cross = ((ay <= row) & (by > row)) | ((by <= row) & (ay > row))
        with np.errstate(divide="ignore", invalid="ignore"):
            xs = ax + (row - ay) * (bx - ax) / (by - ay)
        xs = np.sort(np.where(cross, xs, np.float32(np.inf)), axis=1)
        count = cross.sum(axis=1)
        cover = np.zeros((len(row), w + 1), np.int32)
        for i in range(0, n - 1, 2):
            live = i + 1 < count
            if not live.any():
                break
            r = np.nonzero(live)[0]
            a = np.maximum(0, np.ceil(xs[r, i]).astype(np.int64))
            b = np.minimum(w - 1, np.floor(xs[r, i + 1]).astype(np.int64))
            keep = a <= b
            np.add.at(cover, (r[keep], a[keep]), 1)
            np.add.at(cover, (r[keep], b[keep] + 1), -1)
        band = mask[y0:y1 + 1]
        band[np.cumsum(cover, axis=1)[:, :w] > 0] = value
    # the outline
    for i in range(n):
        dx, dy = bx[i] - ax[i], by[i] - ay[i]
        steps = int(max(abs(dx), abs(dy))) + 1
        t = np.arange(steps + 1, dtype=np.float32) / np.float32(steps)
        x = _lround(ax[i] + t * dx)
        y = _lround(ay[i] + t * dy)
        keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        mask[y[keep], x[keep]] = value
    return mask


def rasterize_annotations(height: int, width: int, annotations) -> np.ndarray:
    """COCO annotations -> semantic mask: each annotation's flattened
    segmentation points, floored to integers, are filled with
    category_id + 1 (0 = background), in annotation order."""
    mask = np.zeros((height, width), dtype=np.uint8)
    for ann in annotations:
        points = np.asarray(ann["segmentation"],
                            dtype=np.float64).reshape(-1, 2)
        fill_polygon(mask, np.floor(points + 0.0).astype(np.int64),
                     int(ann["category_id"]) + 1)
    return mask
