"""ConvNeXt trunk (port of pytorch_segmentation_tpu/nn/backbones/convnext.py;
Liu et al., CVPR 2022), torchvision's structure under the JAX package's
names:
  - `stem_conv` (4x4, stride 4, with bias), then the LayerNorm `stem_norm`;
  - four stages of `stage{s}_block{b}`, joined by the LayerNorm
    `down{s}_norm` and the 2x2 stride-2 conv `down{s}_conv`;
  - a block: the depthwise 7x7 `dwconv` (with bias), the LayerNorm `norm`
    over channels, `fc1` (4C), exact GELU, `fc2` (C), the layer scale
    `gamma` (C,) cast to the compute dtype and multiplied there, the
    residual.
Every LayerNorm has eps 1e-6. The trunk runs on NHWC tensors, as the JAX
module does: the LayerNorms and Dense layers act on the last axis, and the
convolutions see the NCHW view (channels_last strides). It returns the four
stage outputs at strides 4, 8, 16 and 32 as NCHW views. Drop-path is
omitted, as in the JAX module. `remat=True` recomputes each block in the
backward (`nn.blocks.checkpoint`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..blocks import LayerNorm, Linear, checkpoint, nhwc_conv

__all__ = ["ConvNeXt", "CONVNEXT_VARIANTS"]

# depths, dims (the JAX package's table: torchvision convnext_tiny / small /
# base, and its 'pico' test size)
CONVNEXT_VARIANTS = {
    "pico": ((1, 1, 1, 1), (16, 32, 64, 128)),
    "t": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "s": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "b": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}


class _CNBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim, bias=True)
        self.norm = LayerNorm(dim, dtype)
        self.fc1 = Linear(dim, 4 * dim, dtype)
        self.fc2 = Linear(4 * dim, dim, dtype)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NHWC
        h = self.norm(nhwc_conv(self.dwconv, x, self.dtype))
        h = self.fc2(F.gelu(self.fc1(h), approximate="none"))
        return x + self.gamma.to(h.dtype) * h


class ConvNeXt(nn.Module):
    """Returns the four stage maps (NCHW) at strides 4/8/16/32, `dims`
    wide."""

    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        self.depths, self.dtype, self.remat = tuple(depths), dtype, remat
        self.stem_conv = nn.Conv2d(in_channels, dims[0], 4, stride=4,
                                   bias=True)
        self.stem_norm = LayerNorm(dims[0], dtype)
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            if s > 0:
                self.add_module(f"down{s}_norm", LayerNorm(dims[s - 1], dtype))
                self.add_module(f"down{s}_conv", nn.Conv2d(
                    dims[s - 1], dim, 2, stride=2, bias=True))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", _CNBlock(dim, dtype))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem_norm(nhwc_conv(self.stem_conv, x.permute(0, 2, 3, 1),
                                     self.dtype))
        taps = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = nhwc_conv(getattr(self, f"down{s}_conv"),
                              getattr(self, f"down{s}_norm")(x), self.dtype)
            for b in range(depth):
                block = getattr(self, f"stage{s}_block{b}")
                x = checkpoint(block, x) if self.remat else block(x)
            taps.append(x.permute(0, 3, 1, 2))
        return taps
