"""Boundary IoU (Cheng et al., CVPR 2021), streaming, on the tensors' device
(port of pytorch_segmentation_tpu/ops/boundary.py).

  band(M, d)   = M & ~erode(M, d)     (the official mask_to_boundary: the
                                       inner band of width d; erosion by a
                                       (2d+1)^2 square with zero padding,
                                       so image-edge mask pixels are
                                       boundary)
  BIoU_c       = |band(G_c) & band(P_c)| / |band(G_c) | band(P_c)|

d = dilation_ratio * image diagonal (official default 0.02). Erosion is a
min-pool; classes go through a Python loop, so memory stays at [B, H, W] per
class and no [B, H, W, C] one-hot exists.

Void handling: ignored pixels (sample padding or an ignore index) are removed
from BOTH masks before the morphology (they read as background for the band
computation) and therefore never enter the intersection/union sums.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["boundary_pixels", "mask_to_band", "boundary_confusion",
           "boundary_iou"]


def boundary_pixels(h: int, w: int, ratio: float = 0.02) -> int:
    """The official api's pixel width: ratio * image diagonal, >= 1."""
    return max(1, int(round(ratio * math.sqrt(h * h + w * w))))


def mask_to_band(mask: torch.Tensor, d: int) -> torch.Tensor:
    """Inner boundary band of a bool mask [..., H, W]: mask minus its
    erosion by a (2d+1)^2 square, zero-padded (edges count as boundary).

    The square structuring element is separable, so the erosion runs as two
    1-D min-pools (a min-pool is a negated max-pool of the negated mask)."""
    h, w = mask.shape[-2], mask.shape[-1]
    mf = F.pad(mask.reshape(-1, 1, h, w).float(), (d, d, d, d))
    eroded = -F.max_pool2d(-mf, (2 * d + 1, 1), stride=1)
    eroded = -F.max_pool2d(-eroded, (1, 2 * d + 1), stride=1)
    return mask & (eroded.reshape(mask.shape) < 0.5)


def boundary_confusion(pred: torch.Tensor, target: torch.Tensor,
                       num_classes: int, d: int, valid=None):
    """Per-class boundary (intersection, union) sums for one batch.

    pred/target: [B, H, W] int; valid: optional [B, H, W] (or broadcastable)
    bool: False pixels leave both masks before the band morphology. Returns
    two f32 vectors of length num_classes, accumulable across batches (sum,
    then `boundary_iou`)."""
    if valid is None:
        valid = torch.ones((), dtype=torch.bool, device=pred.device)
    valid = valid.to(torch.bool)
    inter, union = [], []
    for c in range(num_classes):
        gb = mask_to_band((target == c) & valid, d)
        pb = mask_to_band((pred == c) & valid, d)
        inter.append((gb & pb).sum())
        union.append((gb | pb).sum())
    return torch.stack(inter).float(), torch.stack(union).float()


def boundary_iou(b_inter, b_union):
    """Per-class Boundary IoU with the zero-guard of `compute_metrics`:
    classes absent from both boundaries report 0. Tensors or numpy in, f32
    tensor out."""
    b_inter = torch.as_tensor(b_inter).float()
    b_union = torch.as_tensor(b_union).float()
    return b_inter / torch.where(b_union <= 0, torch.ones_like(b_union),
                                 b_union)
