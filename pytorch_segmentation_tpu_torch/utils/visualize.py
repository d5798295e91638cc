"""Batch visualizer (port of pytorch_segmentation_tpu/utils/visualize.py):
denormalize the first 8 images, colorize predictions via VOC_COLORMAP, stack
the batch vertically with image|mask side by side, write batch.png.

The JAX package hands a BGR canvas to OpenCV; this one writes the same
picture with the port's own PNG encoder, which takes RGB, and resizes masks
by nearest-neighbour index arithmetic (`ops/resize.resize_nearest`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.colormap import colorize_mask
from ..data.datasets import IMAGENET_MEAN, IMAGENET_STD
from ..ops.resize import resize_nearest
from .png import encode_png

__all__ = ["show_batch"]


def show_batch(images, preds, path: str = "batch.png", max_images: int = 8):
    """images: [B, H, W, 3] ImageNet-normalized float (NHWC); preds:
    [B, H, W] int class ids (numpy arrays or tensors). Masks may be at
    another resolution than the images: they are nearest-resized to the
    image size for display. Writes the PNG and returns the RGB canvas."""
    imgs = torch.as_tensor(images)[:max_images].float().cpu().numpy()
    segs = torch.as_tensor(preds)[:max_images].cpu()
    imgs = imgs * IMAGENET_STD + IMAGENET_MEAN
    imgs = np.clip(imgs, 0, 255).astype(np.uint8)
    h, w = imgs.shape[1:3]
    segs = resize_nearest(segs, (h, w)).numpy()
    colored = np.stack([colorize_mask(s)[..., ::-1] for s in segs])  # -> RGB
    canvas = np.concatenate([imgs.reshape(-1, w, 3),
                             colored.reshape(-1, w, 3)], axis=1)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(canvas)))
    return canvas
