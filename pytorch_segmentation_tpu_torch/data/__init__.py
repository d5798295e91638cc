"""Data: colour maps, the host loader, the device-side augmentation and the
batch pipeline."""

from .augment import AugmentConfig, make_augment_fn
from .colormap import VOC_COLORMAP, colorize_mask, voc_colormap
from .datasets import IMAGENET_MEAN, IMAGENET_STD
from .loader import Batch, DataLoader, Fetcher, repeat_factors
from .pipeline import PostFetch, multi_scale_sizes, normalize_images

__all__ = [
    "VOC_COLORMAP", "voc_colormap", "colorize_mask",
    "IMAGENET_MEAN", "IMAGENET_STD",
    "DataLoader", "Fetcher", "Batch", "repeat_factors",
    "PostFetch", "normalize_images", "multi_scale_sizes",
    "AugmentConfig", "make_augment_fn",
]
