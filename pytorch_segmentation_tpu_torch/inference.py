"""Mask serving paths (port of `make_mask_fn`, `_tile_offsets` and
`make_tiled_mask_fn` in pytorch_segmentation_tpu/inference.py).

Fixed size: normalize -> forward -> upsample+argmax, on the model's device.
Stride-4 logits go through `fused_upsample_argmax`: the hand-written kernel
on a CUDA tensor, its plain PyTorch version on a CPU tensor. Softmax is
skipped: the per-pixel argmax of the logits equals that of the
probabilities. Sliding window: the same forward over a grid of tiles of the
training resolution, logits summed on a canvas, one argmax.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .data.pipeline import normalize_images
from .engine.steps import nhwc_forward, require_eval_mode
from .ops.kernels.upsample_argmax import fused_upsample_argmax
from .ops.resize import resize_bilinear
from .ops.tta import normalize_tta_scales, tta_logits

__all__ = ["make_mask_fn", "make_tiled_mask_fn", "sum_tile_logits"]


def _serving_input(model, legacy_preproc: bool):
    """-> `prepare(images_u8)`: checks a u8 [B, H, W, 3] batch (numpy or
    tensor), moves it to the model's device and normalizes it to f32 NHWC."""
    device = next(model.parameters()).device

    def prepare(images_u8):
        if not isinstance(images_u8, torch.Tensor):
            images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
        x = images_u8.to(device)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected uint8 [B, H, W, 3] images, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if legacy_preproc:
            return x.to(torch.float32) / 255.0
        return normalize_images(x)
    return prepare


def make_mask_fn(model: torch.nn.Module, out_hw=None,
                 legacy_preproc: bool = False, tta_flip: bool = False,
                 tta_scales=(), mesh=None):
    """model: an eval-mode module (engine.checkpoint.load_model_bundle).
    Returns fn(images_u8 [B, H, W, 3] RGB, numpy or tensor) -> int32 masks
    [B, *out_hw] on the model's device. out_hw=None keeps the input size.
    legacy_preproc=True divides by 255 instead of the ImageNet
    normalization. tta_flip=True averages the logits with those of a second
    forward on the horizontally flipped batch before the upsample+argmax;
    tta_scales adds forwards at other input scales (ops/tta.py), composing
    with the flip. Each call raises a ValueError if any submodule of `model`
    is in train mode."""
    if mesh is not None:
        raise NotImplementedError("multi-card serving is not ported yet "
                                  "(ROADMAP: parallel/)")
    prepare = _serving_input(model, legacy_preproc)
    align = getattr(model, "up_align_corners", True)
    tta_scales = normalize_tta_scales(tta_scales)
    fwd = nhwc_forward(model)
    modules = tuple(model.modules())  # each call checks their flags

    @torch.inference_mode()
    def fn(images_u8):
        require_eval_mode(modules, "make_mask_fn")
        x = prepare(images_u8)
        hw = (tuple(int(s) for s in out_hw) if out_hw is not None
              else (x.shape[1], x.shape[2]))
        logits = tta_logits(fwd, x, scales=tta_scales, flip=tta_flip,
                            align_corners=align)
        if (logits.shape[1], logits.shape[2]) == hw:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return fused_upsample_argmax(logits, hw, align_corners=align)
    return fn


def _tile_offsets(size: int, tile: int, overlap: float):
    """Evenly spaced tile offsets covering [0, size) with ~overlap fraction
    of tile overlap; the last tile is flush with the end."""
    if size <= tile:
        return (0,)
    stride = max(1, int(round(tile * (1.0 - overlap))))
    n = -(-(size - tile) // stride) + 1  # ceil
    last = size - tile
    return tuple(int(round(i * last / (n - 1))) for i in range(n))


def sum_tile_logits(fwd_tile, x: torch.Tensor, tile_hw, overlap: float):
    """Run `fwd_tile` (tile [B, th, tw, 3] -> logits [B, th, tw, C]) over the
    grid of `_tile_offsets` windows of `x` [B, H, W, 3] (H >= th, W >= tw)
    and add the f32 logits up on a canvas. Returns the canvas [B, H, W, C]
    and how many tiles cover each pixel, f32 [1, H, W, 1]."""
    b, h, w = x.shape[:3]
    th, tw = tile_hw
    canvas = None
    count = torch.zeros((1, h, w, 1), dtype=torch.float32, device=x.device)
    for y0 in _tile_offsets(h, th, overlap):
        for x0 in _tile_offsets(w, tw, overlap):
            logits = fwd_tile(x[:, y0:y0 + th, x0:x0 + tw]).float()
            if canvas is None:
                canvas = torch.zeros((b, h, w, logits.shape[-1]),
                                     dtype=torch.float32, device=x.device)
            canvas[:, y0:y0 + th, x0:x0 + tw] += logits
            count[:, y0:y0 + th, x0:x0 + tw] += 1.0
    return canvas, count


def make_tiled_mask_fn(model: torch.nn.Module, tile_hw=(513, 513),
                       overlap: float = 0.25, legacy_preproc: bool = False,
                       tta_flip: bool = False, tta_scales=()):
    """Sliding-window serving for images LARGER than the training
    resolution: fn(images_u8 [B, H, W, 3] RGB) -> int32 masks [B, H, W] at
    the input's own resolution.

    The network runs at native resolution over a grid of tile_hw windows
    (~`overlap` fraction overlapping); per-tile logits, upsampled to the
    tile, are summed on a canvas and argmaxed once (the per-pixel argmax
    does not change under the positive per-pixel weight, so the sums are
    not divided by the cover count). An input smaller than a tile is padded
    with the ImageNet mean (zeros after normalize) and the mask cropped
    back. tta_flip / tta_scales compose per tile (ops/tta.py)."""
    prepare = _serving_input(model, legacy_preproc)
    align = getattr(model, "up_align_corners", True)
    th, tw = int(tile_hw[0]), int(tile_hw[1])
    tta_scales = normalize_tta_scales(tta_scales)
    fwd = nhwc_forward(model)
    modules = tuple(model.modules())  # each call checks their flags

    def fwd_tile(x):
        logits = tta_logits(fwd, x, scales=tta_scales, flip=tta_flip,
                            align_corners=align)
        return resize_bilinear(logits.float(), (th, tw), align_corners=align)

    @torch.inference_mode()
    def fn(images_u8):
        require_eval_mode(modules, "make_tiled_mask_fn")
        x = prepare(images_u8)
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, max(w, tw) - w, 0, max(h, th) - h))
        canvas, _ = sum_tile_logits(fwd_tile, x, (th, tw), overlap)
        return torch.argmax(canvas[:, :h, :w], dim=-1).to(torch.int32)
    return fn
