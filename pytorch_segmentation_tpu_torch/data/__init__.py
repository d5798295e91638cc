"""Data: colour maps, the file-reading datasets, the host loader, the
device-side mixes and augmentation and the batch pipeline."""

from .augment import AugmentConfig, make_augment_fn
from .colormap import (VOC_COLORMAP, colorize_mask, mask_from_colors,
                       voc_colormap)
from .datasets import (IMAGENET_MEAN, IMAGENET_STD, IMG_EXT, BasicDataset,
                       CocoDataset, CocoInstance, IdImgDataset,
                       SegImgDataset)
from .loader import Batch, DataLoader, Fetcher, repeat_factors
from .mix import make_mix_fn
from .pipeline import PostFetch, multi_scale_sizes, normalize_images

__all__ = [
    "VOC_COLORMAP", "voc_colormap", "colorize_mask", "mask_from_colors",
    "IMG_EXT", "IMAGENET_MEAN", "IMAGENET_STD",
    "BasicDataset", "CocoDataset", "CocoInstance", "IdImgDataset",
    "SegImgDataset",
    "DataLoader", "Fetcher", "Batch", "repeat_factors",
    "PostFetch", "normalize_images", "multi_scale_sizes",
    "AugmentConfig", "make_augment_fn", "make_mix_fn",
]
