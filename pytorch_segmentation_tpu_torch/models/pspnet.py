"""PSPNet and FastFCN, NCHW (port of pytorch_segmentation_tpu/models/
pspnet.py).

ResNet-50 at output stride 8 (layers 3 and 4 dilated); the pyramid pooling
module over bins (1, 2, 3, 6): each bin adaptively average-pools the 2048
channels (`ops/pool.adaptive_avg_pool2d`), projects them to 512 with a 1x1
ConvNormAct and resizes them back (bilinear, align_corners=True); the
concat (2048 + 4 x 512 = 4096 channels) -> 3x3 ConvNormAct to 512 (`head`)
-> 1x1 class conv with bias. With `full_res_output=True` a x8 bilinear
upsample (align_corners=True) follows.

jpu=True (`--model fastfcn`) takes the undilated backbone (output stride
32) and FastFCN's joint pyramid upsampling in place of the dilated stages:
layer 2, 3 and 4 -> a 3x3 ConvNormAct to 512 each (`jpu_conv{2,3,4}`),
resized to layer 2's size (stride 8, align_corners=True), concatenated
(1536), four `SeparableConvNormAct` to 512 at dilations 1, 2, 4 and 8
(`jpu_dil{d}`), concatenated (2048): what the pyramid pooling reads.

aux=True adds the auxiliary FCN head on layer 3 (`aux_conv`, a 3x3
ConvNormAct to 256, and `aux_cls`, a 1x1 class conv with bias), at layer
3's stride (8 for PSPNet, 16 for FastFCN). A train-mode forward then
returns (logits, aux_logits), the aux logits never upsampled here; the
train step adds `aux_weight` times their loss. An eval-mode forward
returns the logits alone and does not run the head (the JAX module runs it
and drops the result). `remat=True` recomputes the ResNet's residual blocks
in the backward.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.resnet import ResNet
from ..nn.blocks import ConvNormAct, SeparableConvNormAct, conv2d
from ..ops.pool import adaptive_avg_pool2d
from ..ops.resize import resize_bilinear_nchw

__all__ = ["PSPNet"]


class PSPNet(nn.Module):
    output_stride = 8  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, backbone_layers=(3, 4, 6, 3),
                 bins=(1, 2, 3, 6), dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True, up_align_corners: bool = True,
                 jpu: bool = False, aux: bool = False, remat: bool = False,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        self.num_classes = num_classes
        self.bins = tuple(bins)
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.jpu = jpu
        self.aux = aux
        dilation = (False, False, False) if jpu else (False, True, True)
        self.backbone = ResNet("bottleneck", backbone_layers,
                               replace_stride_with_dilation=dilation,
                               dtype=dtype, remat=remat)
        if jpu:
            for i, channels in ((2, 512), (3, 1024), (4, 2048)):
                self.add_module(f"jpu_conv{i}", ConvNormAct(
                    channels, 512, 3, dtype=dtype))
            for d in (1, 2, 4, 8):
                self.add_module(f"jpu_dil{d}", SeparableConvNormAct(
                    1536, 512, 3, dilation=d, dtype=dtype))
        for b in self.bins:
            self.add_module(f"ppm_conv{b}", ConvNormAct(2048, 512, 1,
                                                        dtype=dtype))
        self.head = ConvNormAct(2048 + 512 * len(self.bins), 512, 3,
                                dtype=dtype)
        self.cls_conv = nn.Conv2d(512, num_classes, 1, bias=True)
        if aux:
            self.aux_conv = ConvNormAct(1024, 256, 3, dtype=dtype)
            self.aux_cls = nn.Conv2d(256, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor):
        """x: [B, 3, H, W] float -> logits [B, C, h, w] in the compute
        dtype at stride 8 (or x8 that with full_res_output); with aux in
        train mode, (logits, aux logits at layer 3's stride)."""
        features = self.backbone(x)
        if self.jpu:
            taps = [getattr(self, f"jpu_conv{i}")(features[i])
                    for i in (2, 3, 4)]
            size = tuple(taps[0].shape[2:])   # stride 8
            taps = [taps[0]] + [resize_bilinear_nchw(t, size,
                                                     align_corners=True)
                                for t in taps[1:]]
            cat = torch.cat(taps, dim=1)      # 1536 channels
            y = torch.cat([getattr(self, f"jpu_dil{d}")(cat)
                           for d in (1, 2, 4, 8)], dim=1)   # 2048
        else:
            y = features[-1]   # 2048 channels at stride 8 (dilated)
        h, w = y.shape[2:]
        branches = [y]
        for b in self.bins:
            p = getattr(self, f"ppm_conv{b}")(adaptive_avg_pool2d(y, (b, b)))
            branches.append(resize_bilinear_nchw(p, (h, w),
                                                 align_corners=True))
        y = self.head(torch.cat(branches, dim=1))   # from 4096 channels
        y = conv2d(self.cls_conv, y, self.dtype)
        if self.full_res_output:
            y = resize_bilinear_nchw(y, (8 * y.shape[2], 8 * y.shape[3]),
                                     align_corners=True)
        if self.aux and self.training:
            a = conv2d(self.aux_cls, self.aux_conv(features[3]), self.dtype)
            return y, a
        return y
