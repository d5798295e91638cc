"""Dataset constants (from pytorch_segmentation_tpu/data/datasets.py). The
dataset classes themselves read JPEG and COCO files through OpenCV and are
not ported yet (ROADMAP: Trainer rest and CLIs); `data/loader.DataLoader`
takes any object with `__len__` and `__getitem__ -> (image u8 [H, W, 3],
labels u8 [H, W])`."""

from __future__ import annotations

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD"]

# ImageNet statistics on the 0..255 scale, RGB order
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)
