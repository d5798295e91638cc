"""UNet on a MobileNetV2 encoder, NCHW (port of
pytorch_segmentation_tpu/models/unet.py).

Decoder: three ConvNormAct up-convolutions (1280 -> 256, 352 -> 128,
160 -> 64), each followed by a x2 bilinear align_corners=True upsample and
the concatenation of the encoder tap at that stride (x4, x3, x2); one more
x2 upsample of the 88 channels, then a 3x3 class conv with bias, at stride
2. With `full_res_output=True` a final x2 upsample follows; with False the
model returns stride-2 logits and the caller upsamples (the serving path
fuses that into the upsample+argmax kernel, the Trainer into the
upsample+CE loss).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.mobilenetv2 import MOBILENETV2_TAP_CHANNELS, MobileNetV2
from ..nn.blocks import ConvNormAct, conv2d
from ..ops.resize import resize_bilinear_nchw

__all__ = ["UNet"]


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear_nchw(x, (2 * x.shape[2], 2 * x.shape[3]),
                                align_corners=True)


class UNet(nn.Module):
    output_stride = 2  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True, up_align_corners: bool = True,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        _, c2, c3, c4, c5 = MOBILENETV2_TAP_CHANNELS
        self.backbone = MobileNetV2(dtype=dtype)
        self.up_conv0 = ConvNormAct(c5, 256, dtype=dtype)
        self.up_conv1 = ConvNormAct(256 + c4, 128, dtype=dtype)
        self.up_conv2 = ConvNormAct(128 + c3, 64, dtype=dtype)
        self.cls_conv = nn.Conv2d(64 + c2, num_classes, 3, padding=1,
                                  bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] float, H and W multiples of 32 -> logits
        [B, C, H/2, W/2] in the compute dtype (or [B, C, H, W] with
        full_res_output)."""
        _, x2, x3, x4, x = self.backbone(x)  # the stride-2 tap is unused
        x = torch.cat([_up2(self.up_conv0(x)), x4], dim=1)   # 256 + 96
        x = torch.cat([_up2(self.up_conv1(x)), x3], dim=1)   # 128 + 32
        x = torch.cat([_up2(self.up_conv2(x)), x2], dim=1)   # 64 + 24
        x = conv2d(self.cls_conv, _up2(x), self.dtype)
        if self.full_res_output:
            x = _up2(x)
        return x
