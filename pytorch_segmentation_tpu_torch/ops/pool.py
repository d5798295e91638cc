"""Adaptive average pooling (port of pytorch_segmentation_tpu/ops/pool.py).

Output cell (i, j) averages the input window
[floor(i*H/k), ceil((i+1)*H/k)) x [floor(j*W/k), ceil((j+1)*W/k)), which
are torch's own `AdaptiveAvgPool2d` windows, so `F.adaptive_avg_pool2d`
computes it: the sum in f32, divided by the window's size and rounded once
to the input's dtype, as the JAX package's mean is. The JAX function takes
NHWC; this one takes the port's NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["adaptive_avg_pool2d"]


def adaptive_avg_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x: [B, C, H, W] -> [B, C, kh, kw], the means over torch-adaptive
    windows."""
    return F.adaptive_avg_pool2d(x, (int(out_hw[0]), int(out_hw[1])))
