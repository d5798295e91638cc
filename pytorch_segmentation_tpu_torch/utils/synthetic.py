"""Synthetic COCO-format dataset generator (port of
pytorch_segmentation_tpu/utils/synthetic.py without OpenCV).

Small images of coloured shapes (even category ids are squares, odd ones
triangles) with matching COCO polygon annotations, laid out as the train CLI
reads them: train.json / val.json beside the image files. The JSON and every
numpy draw are the JAX package's. The one deliberate difference: the images
are PNG files (`file_name` ends in `.png`, not `.jpg`), since the port reads
PNG only. The shapes are filled by the port's `fill_polygon`, and each
`area` is the polygon's shoelace area (what `cv2.contourArea` gives).
`img_size` may also be (width, height) for non-square images; an int is the
JAX package's square size.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from ..data.rasterize import fill_polygon
from .png import encode_png

__all__ = ["make_synthetic_coco"]


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
        fname = f"{name}_{i:04d}.png"
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
            shape = fill_polygon(np.zeros((height, width), np.uint8), pts, 1)
            img[shape.astype(bool)] = color  # BGR, as the JAX package draws
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
            f.write(encode_png(np.ascontiguousarray(img[:, :, ::-1])))
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
