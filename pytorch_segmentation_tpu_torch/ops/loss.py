"""Segmentation losses (port of pytorch_segmentation_tpu/ops/loss.py: the
cross-entropy path of the train step).

`compute_loss` bilinearly upsamples the logits to the label resolution
(align_corners=True by default) and takes the mean softmax cross-entropy over
all pixels, in f32. `make_loss_fn` is the train step's loss: where the logits
are below the label resolution it goes through the fused upsample+CE kernel
(ops/kernels/softmax_ce.py), which never writes full-resolution logits.

The weighted, focal, dice and Lovász losses and `build_loss` are not ported
yet.
"""

from __future__ import annotations

import torch

from .kernels.softmax_ce import fused_upsample_ce
from .resize import resize_bilinear

__all__ = ["softmax_cross_entropy", "compute_loss", "make_loss_fn"]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int | None = None) -> torch.Tensor:
    """Mean CE over pixels. logits [..., C] any float, labels [...] int.
    Labels are clipped into [0, C) for the gather, as in the JAX package."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe_labels = labels.long()
    if ignore_index is not None:
        valid = labels != ignore_index
        safe_labels = torch.where(valid, safe_labels,
                                  torch.zeros_like(safe_labels))
    safe_labels = safe_labels.clamp(0, logits.shape[-1] - 1)
    true_logit = logits.gather(-1, safe_labels.unsqueeze(-1)).squeeze(-1)
    per_pixel = lse - true_logit
    if ignore_index is not None:
        validf = valid.float()
        return (per_pixel * validf).sum() / validf.sum().clamp(min=1.0)
    return per_pixel.mean()


def compute_loss(logits: torch.Tensor, targets: torch.Tensor,
                 ignore_index: int | None = None,
                 align_corners: bool = True) -> torch.Tensor:
    """logits [B, h, w, C] at the model's output resolution, targets
    [B, H, W] integer class ids: upsample the logits to (H, W) in f32, then
    the mean CE."""
    logits = resize_bilinear(logits.float(), targets.shape[1:3],
                             align_corners=align_corners)
    return softmax_cross_entropy(logits, targets, ignore_index=ignore_index)


def make_loss_fn(align_corners: bool = True, use_pallas: bool = True):
    """Loss for the train step. With `use_pallas` (the JAX package's name
    for "use the fused kernel"), logits below the label resolution go through
    `fused_upsample_ce`: the hand-written CUDA kernels on the card, their
    plain version on the CPU. Logits already at the label resolution, and
    `use_pallas=False`, take `compute_loss`."""
    def loss_fn(logits, targets):
        low_res = tuple(logits.shape[1:3]) != tuple(targets.shape[1:3])
        if use_pallas and low_res:
            return fused_upsample_ce(logits, targets,
                                     align_corners=align_corners)
        return compute_loss(logits, targets, align_corners=align_corners)
    return loss_fn
