"""Fixed-size mask serving path (port of `make_mask_fn` in
pytorch_segmentation_tpu/inference.py).

normalize -> forward -> upsample+argmax, on the model's device. Stride-4
logits go through `fused_upsample_argmax`: the hand-written kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor. Softmax is skipped: the
per-pixel argmax of the logits equals that of the probabilities.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.pipeline import normalize_images
from .ops.kernels.upsample_argmax import fused_upsample_argmax

__all__ = ["make_mask_fn"]


def make_mask_fn(model: torch.nn.Module, out_hw=None,
                 legacy_preproc: bool = False, tta_flip: bool = False,
                 tta_scales=(), mesh=None):
    """model: an eval-mode module (engine.checkpoint.load_model_bundle).
    Returns fn(images_u8 [B, H, W, 3] RGB, numpy or tensor) -> int32 masks
    [B, *out_hw] on the model's device. out_hw=None keeps the input size.
    legacy_preproc=True divides by 255 instead of the ImageNet
    normalization."""
    if tta_flip or tta_scales:
        raise NotImplementedError("test-time augmentation is not ported yet "
                                  "(ROADMAP: losses and extras, ops/tta.py)")
    if mesh is not None:
        raise NotImplementedError("multi-card serving is not ported yet "
                                  "(ROADMAP: parallel/)")
    device = next(model.parameters()).device
    align = getattr(model, "up_align_corners", True)

    @torch.inference_mode()
    def fn(images_u8):
        if not isinstance(images_u8, torch.Tensor):
            images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
        x = images_u8.to(device)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected uint8 [B, H, W, 3] images, got "
                             f"{x.dtype} {tuple(x.shape)}")
        hw = (tuple(int(s) for s in out_hw) if out_hw is not None
              else (x.shape[1], x.shape[2]))
        if legacy_preproc:
            x = x.to(torch.float32) / 255.0
        else:
            x = normalize_images(x)
        # NHWC memory seen as NCHW (channels_last): no copy either way
        logits = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if (logits.shape[1], logits.shape[2]) == hw:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return fused_upsample_argmax(logits, hw, align_corners=align)
    return fn
