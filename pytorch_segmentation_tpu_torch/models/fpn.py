"""Semantic FPN, NCHW (port of pytorch_segmentation_tpu/models/fpn.py).

The ResNet feature pyramid C2..C5 -> a 1x1 lateral ConvNormAct a level (BN,
no activation, so the top-down sum stays linear) to `fpn_channels`; the
top-down path adds each coarser level, nearest-upsampled
(`ops/resize.resize_nearest`), to the next lateral; a 3x3 smoothing
ConvNormAct a level. The head takes every level to stride 4 with (3x3
ConvNormAct -> x2 bilinear, align_corners=False) steps, sums the four
stride-4 maps and applies the 1x1 class conv (with bias). With
`full_res_output=True` a x4 bilinear upsample (align_corners=False)
follows. `block` is 'bottleneck' (ResNet-50, laterals from 256/512/1024/
2048 channels) or 'basic' (ResNet-34, from 64/128/256/512).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.resnet import ResNet
from ..nn.blocks import ConvNormAct, conv2d
from ..ops.resize import resize_bilinear_nchw, resize_nearest

__all__ = ["FPN"]


class FPN(nn.Module):
    output_stride = 4  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, backbone_layers=(3, 4, 6, 3),
                 block: str = "bottleneck", fpn_channels: int = 256,
                 seg_channels: int = 128, dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.block = block
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.backbone = ResNet(block, backbone_layers, dtype=dtype)
        expansion = 4 if block == "bottleneck" else 1
        for i, width in enumerate((64, 128, 256, 512)):
            self.add_module(f"lat{i}", ConvNormAct(
                width * expansion, fpn_channels, 1, activate=None,
                dtype=dtype))
        for i in range(4):
            self.add_module(f"smooth{i}", ConvNormAct(
                fpn_channels, fpn_channels, 3, dtype=dtype))
        for i in range(4):
            for j in range(max(i, 1)):
                self.add_module(f"head{i}_{j}", ConvNormAct(
                    fpn_channels if j == 0 else seg_channels, seg_channels,
                    3, dtype=dtype))
        self.cls_conv = nn.Conv2d(seg_channels, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] float, H and W multiples of 32 -> logits
        [B, C, H/4, W/4] in the compute dtype (or [B, C, H, W] with
        full_res_output)."""
        feats = self.backbone(x)[1:]   # C2..C5
        sizes = [tuple(f.shape[2:]) for f in feats]
        # top-down: lateral 1x1 (linear) + nearest up + add
        p = self.lat3(feats[3])
        pyramid = [p]
        for i in (2, 1, 0):
            up = resize_nearest(p.permute(0, 2, 3, 1), sizes[i])
            p = getattr(self, f"lat{i}")(feats[i]) + up.permute(0, 3, 1, 2)
            pyramid.insert(0, p)
        pyramid = [getattr(self, f"smooth{i}")(p)
                   for i, p in enumerate(pyramid)]
        # the head: every level to stride 4, then the sum
        y = self.head0_0(pyramid[0])
        for i in (1, 2, 3):
            z = pyramid[i]
            for j in range(i):
                z = getattr(self, f"head{i}_{j}")(z)
                z = resize_bilinear_nchw(z, sizes[i - 1 - j],
                                         align_corners=False)
            y = y + z
        y = conv2d(self.cls_conv, y, self.dtype)
        if self.full_res_output:
            y = resize_bilinear_nchw(y, (4 * y.shape[2], 4 * y.shape[3]),
                                     align_corners=False)
        return y
