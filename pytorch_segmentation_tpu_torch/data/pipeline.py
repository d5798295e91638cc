"""Batch normalization of u8 images (port of `normalize_images` in
pytorch_segmentation_tpu/data/pipeline.py). Augmentation and the post-fetch
hook come with the train slice."""

from __future__ import annotations

import torch

from .datasets import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["normalize_images"]


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 RGB NHWC -> ImageNet-normalized float NHWC, computed in f32 on
    the images' device."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = images.to(torch.float32)
    return ((x - mean) / std).to(dtype)
