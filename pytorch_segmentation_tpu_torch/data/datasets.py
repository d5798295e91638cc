"""Dataset constants (from pytorch_segmentation_tpu/data/datasets.py). The
datasets themselves come with the train slice."""

from __future__ import annotations

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD"]

# ImageNet statistics on the 0..255 scale, RGB order
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)
