"""RectLoss, the rectangularity prior (port of
pytorch_segmentation_tpu/ops/rect_loss.py).

For every (sample, class) the rotated bounding rectangle of the predicted
class mask comes from its image moments, with no host round-trip:

  1. class mask m = (argmax(logits) == c)
  2. principal axis angle from the second central moments:
     theta = 0.5 * atan2(2*mu11, mu20 - mu02)
  3. extents = min/max of the mask pixels' projections onto the axes
  4. target = the pixels whose projections lie within the extents (dilated
     by half a pixel)

The rectangle covers ALL pixels of the class, not only its largest
connected component, as in the JAX package. Targets come from the argmax
and carry no gradient; the loss is BCE with logits against them.
"""

from __future__ import annotations

import torch

from .loss import jax_abs

__all__ = ["rect_targets", "rect_loss"]


def _rect_mask(mask: torch.Tensor, ys: torch.Tensor,
               xs: torch.Tensor) -> torch.Tensor:
    """mask [B, H, W] f32 of one class -> [B, H, W] f32 filled rectangle
    (0 where the class is absent), in the JAX function's order of
    operations."""
    def total(x):
        return x.sum(dim=(1, 2), keepdim=True)

    area = total(mask)
    safe = area.clamp(min=1.0)
    cx = total(mask * xs) / safe
    cy = total(mask * ys) / safe
    dx = xs - cx
    dy = ys - cy
    mu20 = total(mask * dx * dx) / safe
    mu02 = total(mask * dy * dy) / safe
    mu11 = total(mask * dx * dy) / safe
    theta = 0.5 * torch.atan2(2.0 * mu11, mu20 - mu02)
    c, s = torch.cos(theta), torch.sin(theta)
    u = dx * c + dy * s
    v = -dx * s + dy * c
    inside = mask > 0

    def extent(x):
        lo = torch.where(inside, x, 1e9).amin(dim=(1, 2), keepdim=True)
        hi = torch.where(inside, x, -1e9).amax(dim=(1, 2), keepdim=True)
        return (x >= lo - 0.5) & (x <= hi + 0.5)

    rect = extent(u) & extent(v)
    return torch.where(area > 0, rect.float(), torch.zeros_like(mask))


@torch.no_grad()
def rect_targets(pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """pred [B, H, W] int argmax labels -> [B, H, W, C] f32 filled rotated
    rectangles (0 where the class is absent). One class at a time: each
    temporary is [B, H, W] (34 MB at batch 32 and 513²), not [B, H, W, C]."""
    _, h, w = pred.shape
    ys = torch.arange(h, dtype=torch.float32,
                      device=pred.device).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32,
                      device=pred.device).view(1, 1, w)
    return torch.stack([_rect_mask((pred == c).float(), ys, xs)
                        for c in range(num_classes)], dim=-1)


def rect_loss(logits: torch.Tensor, weight: float = 1.0,
              reduction: str = "mean") -> torch.Tensor:
    """logits [B, H, W, C]: BCE with logits against the per-class rotated
    rectangles of the current prediction; `reduction` 'mean', 'sum' or
    'none' (the [B, H, W, C] terms)."""
    logits = logits.float()
    targets = rect_targets(torch.argmax(logits, dim=-1), logits.shape[-1])
    bce = (torch.maximum(logits, logits.new_zeros(())) - logits * targets
           + torch.log1p(torch.exp(-jax_abs(logits))))
    bce = bce * weight
    if reduction == "none":
        return bce
    if reduction == "sum":
        return bce.sum()
    return bce.mean()
