"""UPerNet, NCHW (port of pytorch_segmentation_tpu/models/upernet.py; Xiao
et al., ECCV 2018, mmseg UPerHead conventions).

The encoder's C2..C5 pyramid, named `backbone`: the port's `ResNet(block,
layers)` (taps 1..4; `block` 'bottleneck' for R50 or 'basic' for R34),
SegFormer's Mix Transformer (`encoder='mit'`, `mit_variant` a key of
SEGFORMER_VARIANTS), ConvNeXt (`encoder='convnext'`, `convnext_variant` of
CONVNEXT_VARIANTS), Swin (`encoder='swin'`, `swin_variant` of
SWIN_VARIANTS), or the plain ViT (`encoder='vit'`, `vit_variant` of
VIT_VARIANTS) with mmseg's MultiLevelNeck: for each of its four stride-16
taps a raw biased 1x1 conv `neck_lat{i}` (dim -> dim, no norm, no
activation), a bilinear rescale by 4, 2, 1 and 0.5 to int(t * s)
(align_corners=False; none at 1), and a raw biased 3x3 conv `neck_conv{i}`.
The head, every resize bilinear with align_corners=False:
  - PPM on C5: for each pool scale s (1, 2, 3, 6) an adaptive average pool
    to s x s (`ops/pool.adaptive_avg_pool2d`, torch's windows, so a C5
    smaller than s pools UP), a 1x1 ConvNormAct `ppm_conv{s}` to
    `channels`, the resize back; the concat [C5, p1, p2, p3, p6] -> 3x3
    ConvNormAct `ppm_bottleneck`: the pyramid top.
  - FPN: 1x1 ConvNormAct laterals `lat0..2` (BN and ReLU) on C2..C4, the
    top-down adds, a 3x3 ConvNormAct `fpn_conv{i}` a merged level; the
    top passes through.
  - Fuse: every level to stride 4, the concat (4 x `channels`) -> 3x3
    ConvNormAct `fpn_bottleneck` -> 1x1 class conv `cls_conv` with bias.
    `full_res_output=True` resizes to 4x the logits' size.
aux=True adds the FCN auxiliary head on C4 (`aux_conv`, a 3x3 ConvNormAct
to 256, and `aux_cls`, a 1x1 class conv with bias) at C4's stride (16): a
train-mode forward then returns (logits, aux logits), the aux logits never
upsampled here; an eval-mode forward returns the logits alone and does not
run the head (the JAX module runs it and drops the result).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.convnext import CONVNEXT_VARIANTS, ConvNeXt
from ..nn.backbones.resnet import ResNet
from ..nn.backbones.swin import SWIN_VARIANTS, SwinTransformer
from ..nn.backbones.vit import VIT_VARIANTS, ViT
from ..nn.blocks import ConvNormAct, conv2d
from ..ops.pool import adaptive_avg_pool2d
from ..ops.resize import resize_bilinear_nchw
from .segformer import SEGFORMER_VARIANTS, _MiT, _refuse_unported

__all__ = ["UPerNet", "UNPORTED_ENCODERS"]

# the JAX module's encoders that the port lacks: none
UNPORTED_ENCODERS = ()
NECK_SCALES = (4, 2, 1, 0.5)   # the MultiLevelNeck's rescale of each tap


class UPerNet(nn.Module):
    output_stride = 4  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, encoder: str = "resnet",
                 backbone_layers=(3, 4, 6, 3), block: str = "bottleneck",
                 mit_variant: str = "b0", convnext_variant: str = "t",
                 swin_variant: str = "t", vit_variant: str = "b16",
                 channels: int = 512, pool_scales=(1, 2, 3, 6),
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, remat: bool = False,
                 aux: bool = False,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        if encoder not in ("resnet", "mit", "convnext", "swin", "vit"):
            raise ValueError(f"unknown UPerNet encoder {encoder!r}")
        _refuse_unported(remat=remat)
        self.num_classes = num_classes
        self.encoder = encoder
        self.block = block
        self.channels = channels
        self.pool_scales = tuple(pool_scales)
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.aux = aux
        if encoder == "mit":
            dims, depths, heads, _ = SEGFORMER_VARIANTS[mit_variant]
            self.backbone = _MiT(dims, depths, heads, dtype=dtype)
            widths = tuple(dims)
        elif encoder == "convnext":
            depths, dims = CONVNEXT_VARIANTS[convnext_variant]
            self.backbone = ConvNeXt(depths, dims, dtype=dtype)
            widths = tuple(dims)
        elif encoder == "swin":
            depths, dim, heads, window = SWIN_VARIANTS[swin_variant]
            self.backbone = SwinTransformer(depths, dim, heads, window,
                                            dtype=dtype)
            widths = tuple(dim * 2 ** s for s in range(4))
        elif encoder == "vit":
            layers, dim, heads, patch, base_grid, out_idx = \
                VIT_VARIANTS[vit_variant]
            self.backbone = ViT(layers, dim, heads, patch, base_grid,
                                out_idx, dtype=dtype)
            for i in range(len(NECK_SCALES)):
                self.add_module(f"neck_lat{i}", nn.Conv2d(dim, dim, 1,
                                                          bias=True))
                self.add_module(f"neck_conv{i}", nn.Conv2d(
                    dim, dim, 3, padding=1, bias=True))
            widths = (dim,) * 4
        else:
            self.backbone = ResNet(block, backbone_layers, dtype=dtype)
            expansion = 4 if block == "bottleneck" else 1
            widths = tuple(w * expansion for w in (64, 128, 256, 512))
        for s in self.pool_scales:
            self.add_module(f"ppm_conv{s}", ConvNormAct(
                widths[3], channels, 1, dtype=dtype))
        self.ppm_bottleneck = ConvNormAct(
            widths[3] + len(self.pool_scales) * channels, channels, 3,
            dtype=dtype)
        for i in range(3):
            self.add_module(f"lat{i}", ConvNormAct(widths[i], channels, 1,
                                                   dtype=dtype))
        for i in range(3):
            self.add_module(f"fpn_conv{i}", ConvNormAct(channels, channels, 3,
                                                        dtype=dtype))
        self.fpn_bottleneck = ConvNormAct(4 * channels, channels, 3,
                                          dtype=dtype)
        self.cls_conv = nn.Conv2d(channels, num_classes, 1, bias=True)
        if aux:
            self.aux_conv = ConvNormAct(widths[2], 256, 3, dtype=dtype)
            self.aux_cls = nn.Conv2d(256, num_classes, 1, bias=True)

    def _neck(self, i: int, tap: torch.Tensor, scale: float) -> torch.Tensor:
        """The MultiLevelNeck on the ViT's tap `i`: 1x1, rescale, 3x3."""
        y = conv2d(getattr(self, f"neck_lat{i}"), tap, self.dtype)
        if scale != 1:
            y = resize_bilinear_nchw(y, (int(tap.shape[2] * scale),
                                         int(tap.shape[3] * scale)),
                                     align_corners=False)
        return conv2d(getattr(self, f"neck_conv{i}"), y, self.dtype)

    def forward(self, x: torch.Tensor):
        """x: [B, 3, H, W] float, H and W multiples of 32 -> logits
        [B, C, H/4, W/4] in the compute dtype (or 4x that with
        full_res_output); with aux in train mode, (logits, aux logits at
        stride 16)."""
        feats = self.backbone(x)
        if self.encoder == "resnet":
            feats = feats[1:]   # C2..C5
        elif self.encoder == "vit":
            feats = [self._neck(i, t, s)
                     for i, (t, s) in enumerate(zip(feats, NECK_SCALES))]
        sizes = [tuple(f.shape[2:]) for f in feats]
        c5 = feats[3]
        branches = [c5]
        for s in self.pool_scales:
            p = getattr(self, f"ppm_conv{s}")(adaptive_avg_pool2d(c5, (s, s)))
            branches.append(resize_bilinear_nchw(p, sizes[3],
                                                 align_corners=False))
        top = self.ppm_bottleneck(torch.cat(branches, dim=1))
        laterals = [getattr(self, f"lat{i}")(feats[i]) for i in range(3)]
        laterals.append(top)
        for i in (2, 1, 0):
            laterals[i] = laterals[i] + resize_bilinear_nchw(
                laterals[i + 1], sizes[i], align_corners=False)
        pyramid = [getattr(self, f"fpn_conv{i}")(laterals[i])
                   for i in range(3)] + [top]
        outs = [pyramid[0]] + [resize_bilinear_nchw(p, sizes[0],
                                                    align_corners=False)
                               for p in pyramid[1:]]
        y = self.fpn_bottleneck(torch.cat(outs, dim=1))
        y = conv2d(self.cls_conv, y, self.dtype)
        if self.full_res_output:
            y = resize_bilinear_nchw(y, (4 * y.shape[2], 4 * y.shape[3]),
                                     align_corners=False)
        if self.aux and self.training:
            a = conv2d(self.aux_cls, self.aux_conv(feats[2]), self.dtype)
            return y, a
        return y
