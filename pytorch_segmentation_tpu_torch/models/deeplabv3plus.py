"""DeepLabV3+ on a dilated ResNet-50, NCHW (port of
pytorch_segmentation_tpu/models/deeplabv3plus.py).

ResNet at output stride 16 (layer4 dilated); the low-level tap is layer1
(256 ch, stride 4) projected to 128 ch by a 1x1 ConvNormAct; ASPP(2048 -> 256,
rates 6/12/18); bilinear align_corners=True upsample to the tap's size;
concat (384 ch); 3x3 class conv with bias. With `full_res_output=True` a
final x4 bilinear upsample follows; with False the model returns stride-4
logits and the caller upsamples (the serving path fuses that into the
upsample+argmax kernel).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.resnet import ResNet
from ..nn.blocks import ConvNormAct, conv2d
from ..ops.resize import resize_bilinear_nchw
from .aspp import ASPP

__all__ = ["DeepLabV3Plus"]


class DeepLabV3Plus(nn.Module):
    output_stride = 4  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, backbone_layers=(3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True, up_align_corners: bool = True,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.backbone = ResNet("bottleneck", backbone_layers,
                               replace_stride_with_dilation=(False, False,
                                                             True),
                               dtype=dtype)
        self.project = ConvNormAct(256, 128, kernel_size=1, dtype=dtype)
        self.aspp = ASPP(self.backbone.out_channels, 256,
                         atrous_rates=(6, 12, 18), dtype=dtype)
        self.cls_conv = nn.Conv2d(384, num_classes, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] float -> logits [B, C, h, w] in the compute
        dtype (stride 4, or x4 that with full_res_output)."""
        features = self.backbone(x)
        low = self.project(features[1])
        y = self.aspp(features[-1])
        y = resize_bilinear_nchw(y, low.shape[2:], align_corners=True)
        y = torch.cat([y, low], dim=1)
        y = conv2d(self.cls_conv, y, self.dtype)
        if self.full_res_output:
            y = resize_bilinear_nchw(y, (4 * y.shape[2], 4 * y.shape[3]),
                             align_corners=True)
        return y
