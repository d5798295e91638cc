"""LR-ASPP (Lite Reduced ASPP) on MobileNetV3-Large, NCHW (port of
pytorch_segmentation_tpu/models/lraspp.py; torchvision's
`lraspp_mobilenet_v3_large`).

The dilated MobileNetV3-Large (`nn/backbones/mobilenetv3.py`); the head
reads its 40-channel stride-8 tap (low) and 960-channel stride-16 tap
(high):
  - high -> 1x1 ConvNormAct to 128 (`cbr`);
  - high -> the mean over the map in f32 cast back -> 1x1 conv without
    bias (`scale_conv`) -> sigmoid in the compute dtype; cbr times it;
  - that, resized x2 onto the low grid (bilinear, align_corners=False);
  - the sum of a biased 1x1 class conv of low (`low_classifier`) and one
    of it (`high_classifier`), at stride 8;
  - with `full_res_output=True` a x8 bilinear upsample, align_corners
    False.
No auxiliary head and no size variants.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.mobilenetv3 import MobileNetV3
from ..nn.blocks import ConvNormAct, conv2d
from ..ops.resize import resize_bilinear_nchw

__all__ = ["LRASPP"]


class LRASPP(nn.Module):
    output_stride = 8  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, inter_channels: int = 128,
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.backbone = MobileNetV3(dilated=True, dtype=dtype)
        self.cbr = ConvNormAct(960, inter_channels, 1, dtype=dtype)
        self.scale_conv = nn.Conv2d(960, inter_channels, 1, bias=False)
        self.low_classifier = nn.Conv2d(40, num_classes, 1, bias=True)
        self.high_classifier = nn.Conv2d(inter_channels, num_classes, 1,
                                         bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] float -> logits [B, C, h, w] in the compute
        dtype at stride 8 (or x8 that with full_res_output)."""
        taps = self.backbone(x)
        low, high = taps[2], taps[4]   # 40 @ stride 8, 960 @ stride 16
        dt = self.dtype
        s = high.float().mean(dim=(2, 3), keepdim=True).to(high.dtype)
        y = self.cbr(high) * torch.sigmoid(conv2d(self.scale_conv, s, dt))
        y = resize_bilinear_nchw(y, tuple(low.shape[2:]),
                                 align_corners=False)
        out = (conv2d(self.low_classifier, low, dt)
               + conv2d(self.high_classifier, y, dt))
        if self.full_res_output:
            out = resize_bilinear_nchw(
                out, (8 * out.shape[2], 8 * out.shape[3]),
                align_corners=self.up_align_corners)
        return out
