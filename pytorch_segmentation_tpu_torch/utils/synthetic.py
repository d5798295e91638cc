"""Synthetic COCO-format dataset generator (port of
pytorch_segmentation_tpu/utils/synthetic.py without OpenCV).

Small images of coloured shapes (even category ids are squares, odd ones
triangles) with matching COCO polygon annotations, laid out as the train CLI
reads them: train.json / val.json beside the `{name}_{i:04d}.jpg` files.
Every numpy draw is the JAX package's, each shape is drawn as
`cv2.fillPoly(img, [pts], color)` draws it (`fill_poly`), each `area` is
the polygon's shoelace area (what `cv2.contourArea` gives) and each image is
written by `utils/jpeg.encode_jpeg` (the bytes of `cv2.imwrite`), so the
JSON and every file equal the JAX generator's byte for byte. `img_size` may
also be (width, height) for non-square images; an int is the JAX package's
square size.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from .jpeg import encode_jpeg

__all__ = ["make_synthetic_coco", "fill_poly"]

_XY_SHIFT = 16  # OpenCV's drawing fixed point


def _line8(img, x0, y0, x1, y1, color):
    """OpenCV's Line with an 8-connected LineIterator (left to right):
    the major axis steps every pixel, the minor one when the error term
    is negative; step k has taken floor((2 * minor * k + major - 1) /
    (2 * major)) minor steps."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = (2 * minor * k + major - 1) // (2 * major) if major else k
    if dy > dx:
        xs, ys = x0 + m, y0 + sy * k
    else:
        xs, ys = x0 + k, y0 + sy * m
    keep = ((xs >= 0) & (xs < img.shape[1]) & (ys >= 0)
            & (ys < img.shape[0]))
    img[ys[keep], xs[keep]] = color


def fill_poly(img: np.ndarray, pts, color) -> None:
    """`cv2.fillPoly(img, [pts], color)` in place, for int points inside the
    image (LINE_8, shift 0), as OpenCV draws it: each edge's outline by
    `_line8`, then the scanline fill of CollectPolyEdges /
    FillEdgeCollection: 16-bit fixed-point edges (x << 16, dx truncated
    toward zero), active for y0 <= y < y1; on each row the sorted crossings
    are filled in pairs from round(x_left) (half up) to floor(x_right)."""
    pts = np.asarray(pts, dtype=np.int64).reshape(-1, 2)
    n = len(pts)
    edges = []
    for i in range(n):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        _line8(img, int(x0), int(y0), int(x1), int(y1), color)
        if y0 == y1:
            continue
        fx0, fx1 = int(x0) << _XY_SHIFT, int(x1) << _XY_SHIFT
        num, den = fx1 - fx0, int(y1 - y0)
        step = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
        if y0 < y1:
            edges.append((int(y0), int(y1), fx0, step))
        else:
            edges.append((int(y1), int(y0), fx1, step))
    if len(edges) < 2:
        return
    y_lo = max(min(e[0] for e in edges), 0)
    y_hi = min(max(e[1] for e in edges), img.shape[0])
    for y in range(y_lo, y_hi):
        xs = sorted(x + (y - top) * step for top, bottom, x, step in edges
                    if top <= y < bottom)
        for left, right in zip(xs[0::2], xs[1::2]):
            a = max((left + (1 << (_XY_SHIFT - 1))) >> _XY_SHIFT, 0)
            b = min(right >> _XY_SHIFT, img.shape[1] - 1)
            if a <= b:
                img[y, a:b + 1] = color


def _shoelace(pts: np.ndarray) -> float:
    x, y = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
                 / 2.0)


def _make_split(root, name, num_images, img_wh, rng, num_cats):
    width, height = img_wh
    side = min(width, height)
    images = []
    annotations = []
    ann_id = 1
    for i in range(num_images):
        fname = f"{name}_{i:04d}.jpg"
        img = np.full((height, width, 3),
                      rng.integers(40, 216, size=3, dtype=np.int64),
                      dtype=np.uint8)
        img = (img + rng.normal(0, 8, img.shape)).clip(0, 255).astype(np.uint8)
        n_shapes = int(rng.integers(1, 3))
        for _ in range(n_shapes):
            cls = int(rng.integers(0, num_cats))  # even ids box, odd tri
            cx = int(rng.integers(width // 4, 3 * width // 4))
            cy = int(rng.integers(height // 4, 3 * height // 4))
            r = int(rng.integers(side // 8, side // 4))
            if cls % 2 == 0:
                poly = [cx - r, cy - r, cx + r, cy - r, cx + r, cy + r,
                        cx - r, cy + r]
            else:
                poly = [cx, cy - r, cx + r, cy + r, cx - r, cy + r]
            poly = [int(np.clip(v, 1, (width if k % 2 == 0 else height) - 2))
                    for k, v in enumerate(poly)]
            pts = np.asarray(poly, dtype=np.int32).reshape(-1, 2)
            color = (int(rng.integers(0, 255)), int(rng.integers(0, 255)),
                     int(rng.integers(0, 255)))
            fill_poly(img, pts, color)  # BGR, as the JAX package draws
            xs, ys = pts[:, 0], pts[:, 1]
            annotations.append({
                "id": ann_id,
                "image_id": i,
                "category_id": cls,
                "segmentation": poly,
                "bbox": [int(xs.min()), int(ys.min()),
                         int(xs.max() - xs.min()), int(ys.max() - ys.min())],
                "area": _shoelace(pts),
                "iscrowd": 0,
            })
            ann_id += 1
        with open(osp.join(root, fname), "wb") as f:
            f.write(encode_jpeg(img))
        images.append({"id": i, "file_name": fname,
                       "width": width, "height": height})
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": ([{"id": 0, "name": "box"}, {"id": 1, "name": "tri"}]
                       if num_cats == 2 else
                       [{"id": c, "name": f"cat{c}"}
                        for c in range(num_cats)]),
    }
    with open(osp.join(root, f"{name}.json"), "w") as f:
        json.dump(coco, f)


def make_synthetic_coco(root: str, num_train: int = 16, num_val: int = 8,
                        img_size=96, seed: int = 0, num_classes: int = 2):
    """num_classes = shape categories (the dataset adds background, so the
    model trains with num_classes+1 output channels). img_size: an int
    (square) or (width, height)."""
    img_wh = ((img_size, img_size) if isinstance(img_size, int)
              else tuple(int(v) for v in img_size))
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    _make_split(root, "train", num_train, img_wh, rng, num_classes)
    _make_split(root, "val", num_val, img_wh, rng, num_classes)
    return root
