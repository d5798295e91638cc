"""FCN and DeepLabV3, the torchvision segmentation-zoo families, NCHW (port
of pytorch_segmentation_tpu/models/tvseg.py).

Both run on ResNet-50 (or 101: `backbone_layers=(3, 4, 23, 3)`) at output
stride 8 (layers 3 and 4 dilated):
  - FCN: a 3x3 ConvNormAct 2048 -> 512 (`head`) and a 1x1 class conv with
    bias (`cls_conv`).
  - DeepLabV3: ASPP at rates (12, 24, 36) as separate top-level modules: a
    1x1 ConvNormAct (`aspp_b0`), one dilated 3x3 ConvNormAct a rate
    (`aspp_b1`..`aspp_b3`), the pool branch (the mean in f32 cast back, a
    1x1 ConvNormAct `aspp_pool`, broadcast back), concat (1280) -> 1x1
    ConvNormAct to 256 (`aspp_project`) -> 3x3 ConvNormAct (`head`) -> 1x1
    class conv (`cls_conv`).
With `full_res_output=True` a x8 bilinear upsample with align_corners=False
(torchvision's `F.interpolate` default) follows: `8 * h`, so 520 for a 513
input, as in the JAX package.

aux=True adds torchvision's FCNHead on layer 3 as the nested `aux_head`
(`aux_head.aux_conv`, a 3x3 ConvNormAct 1024 -> 256, and
`aux_head.aux_cls`, a 1x1 class conv with bias). A train-mode forward then
returns (logits, aux logits at stride 8, never upsampled here); an
eval-mode forward returns the logits alone and does not run the head.
`remat=True` recomputes the ResNet's residual blocks in the backward.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.resnet import ResNet
from ..nn.blocks import ConvNormAct, conv2d
from ..ops.resize import resize_bilinear_nchw

__all__ = ["FCN", "DeepLabV3"]


class _AuxHead(nn.Module):
    """torchvision's FCNHead on the layer-3 tap: 1024 -> 256 -> classes."""

    def __init__(self, num_classes: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.aux_conv = ConvNormAct(1024, 256, 3, dtype=dtype)
        self.aux_cls = nn.Conv2d(256, num_classes, 1, bias=True)

    def forward(self, c4: torch.Tensor) -> torch.Tensor:
        return conv2d(self.aux_cls, self.aux_conv(c4), self.dtype)


class _DilatedResNetSeg(nn.Module):
    """What FCN and DeepLabV3 share: the output-stride-8 ResNet, the class
    conv, the x8 upsample with align_corners=False and the aux head.
    Subclasses build `head` (and more) and define `decode`."""

    output_stride = 8  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, backbone_layers, head_channels: int,
                 dtype: torch.dtype, full_res_output: bool,
                 up_align_corners: bool, aux: bool, remat: bool):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.aux = aux
        self.backbone = ResNet("bottleneck", backbone_layers,
                               replace_stride_with_dilation=(False, True,
                                                             True),
                               dtype=dtype, remat=remat)
        self.cls_conv = nn.Conv2d(head_channels, num_classes, 1, bias=True)
        if aux:
            self.aux_head = _AuxHead(num_classes, dtype)

    def decode(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor):
        """x: [B, 3, H, W] float -> logits [B, C, h, w] in the compute
        dtype at stride 8 (or x8 that with full_res_output); with aux in
        train mode, (logits, aux logits at stride 8)."""
        features = self.backbone(x)
        y = conv2d(self.cls_conv, self.decode(features[-1]), self.dtype)
        if self.full_res_output:
            y = resize_bilinear_nchw(y, (8 * y.shape[2], 8 * y.shape[3]),
                                     align_corners=self.up_align_corners)
        if self.aux and self.training:
            return y, self.aux_head(features[3])
        return y


class FCN(_DilatedResNetSeg):
    """torchvision fcn_resnet50/101: the dilated ResNet + FCNHead."""

    def __init__(self, num_classes: int, backbone_layers=(3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, aux: bool = False,
                 remat: bool = False, axis_name: str | None = None):
        super().__init__(num_classes, backbone_layers, 512, dtype,
                         full_res_output, up_align_corners, aux, remat)
        self.axis_name = axis_name
        self.head = ConvNormAct(2048, 512, 3, dtype=dtype)

    def decode(self, y):
        return self.head(y)


class DeepLabV3(_DilatedResNetSeg):
    """torchvision deeplabv3_resnet50/101: the dilated ResNet + the
    DeepLabHead (ASPP, no decoder: that is DeepLabV3+)."""

    def __init__(self, num_classes: int, backbone_layers=(3, 4, 6, 3),
                 rates=(12, 24, 36), dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, aux: bool = False,
                 remat: bool = False, axis_name: str | None = None):
        super().__init__(num_classes, backbone_layers, 256, dtype,
                         full_res_output, up_align_corners, aux, remat)
        self.axis_name = axis_name
        self.rates = tuple(rates)
        self.aspp_b0 = ConvNormAct(2048, 256, 1, dtype=dtype)
        for i, rate in enumerate(self.rates):
            self.add_module(f"aspp_b{i + 1}", ConvNormAct(
                2048, 256, 3, dilation=rate, dtype=dtype))
        self.aspp_pool = ConvNormAct(2048, 256, 1, dtype=dtype)
        self.aspp_project = ConvNormAct(256 * (2 + len(self.rates)), 256, 1,
                                        dtype=dtype)
        self.head = ConvNormAct(256, 256, 3, dtype=dtype)

    def decode(self, y):
        h, w = y.shape[2], y.shape[3]
        branches = [self.aspp_b0(y)]
        branches += [getattr(self, f"aspp_b{i + 1}")(y)
                     for i in range(len(self.rates))]
        # the pool branch: mean in f32, cast back to the input's dtype (as
        # models/aspp.py), 1x1 ConvNormAct, broadcast back over the map
        p = y.float().mean(dim=(2, 3), keepdim=True).to(y.dtype)
        branches.append(self.aspp_pool(p).expand(-1, -1, h, w))
        return self.head(self.aspp_project(torch.cat(branches, dim=1)))
