"""Test-time augmentation: flip + multi-scale logit averaging (port of
pytorch_segmentation_tpu/ops/tta.py).

Run the forward at several input scales (and optionally on the horizontally
flipped batch), resize every logit map back to the base scale's logit
resolution, and average. Averaging logits equals a geometric mean of the
softmaxes, the usual formulation. Scaled sizes snap to multiples of 32, the
convention of the multi-scale training resize.

Layout: images and logits are NHWC here, as in the JAX package, so W is
axis 2 of both. The port's models take NCHW; the one permute to the model's
view and back belongs to the `fwd` the caller hands in
(`engine/steps.nhwc_forward`), not to this module.
"""

from __future__ import annotations

import torch

from .resize import resize_bilinear

__all__ = ["normalize_tta_scales", "snap_scale_size", "tta_logits"]


def snap_scale_size(hw, scale: float, snap: int = 32):
    """(H, W) for `scale`, snapped to multiples of `snap` (min one tile)."""
    h, w = int(hw[0]), int(hw[1])
    return (max(snap, int(round(h * scale / snap)) * snap),
            max(snap, int(round(w * scale / snap)) * snap))


def normalize_tta_scales(scales) -> tuple:
    """User scale list -> canonical tuple: floats, deduped, without the base
    1.0 entry (the base forward always runs and defines the output
    resolution). () / None -> () (multi-scale TTA off)."""
    if not scales:
        return ()
    out = []
    for s in scales:
        s = float(s)
        if abs(s - 1.0) < 1e-6 or s <= 0:
            continue
        if s not in out:
            out.append(s)
    return tuple(out)


def tta_logits(fwd, images: torch.Tensor, scales=(), flip: bool = False,
               align_corners: bool = True) -> torch.Tensor:
    """Averaged logits at the BASE forward's resolution and dtype.

    fwd: images [B, H, W, 3] (normalized float) -> logits [B, h, w, C] (any
    fixed stride). scales: extra input scales (base 1.0 is always included).
    flip: average each forward with its horizontally-flipped twin. With
    scales=() and flip=True this is `(logits + flip(fwd(flip(x)))) * 0.5`;
    with both off it is `fwd(images)`."""

    def one(x):
        logits = fwd(x)
        if flip:
            flipped = fwd(torch.flip(x, dims=(2,)))
            logits = (logits + torch.flip(flipped, dims=(2,))) * 0.5
        return logits

    base = one(images)
    h, w = int(images.shape[1]), int(images.shape[2])
    sizes = []
    for s in normalize_tta_scales(scales):
        hw_s = snap_scale_size((h, w), s)
        if hw_s != (h, w) and hw_s not in sizes:
            sizes.append(hw_s)
    if not sizes:
        return base
    acc = base.float()
    out_hw = (base.shape[1], base.shape[2])
    for hw_s in sizes:
        xi = resize_bilinear(images.float(), hw_s,
                             align_corners=align_corners)
        li = one(xi.to(images.dtype))
        acc = acc + resize_bilinear(li.float(), out_hw,
                                    align_corners=align_corners)
    return (acc / (1 + len(sizes))).to(base.dtype)
