"""OCRNet (object-contextual representations) over HRNet, NCHW (port of
pytorch_segmentation_tpu/models/ocrnet.py; Yuan et al., ECCV 2020, mmseg
OCRHead over a cascade FCNHead).

The backbone is `HRNet(feature_output=True)`: every branch of the last
stage resized onto branch 0 and concatenated (480 channels at width 32),
stride 4. The head:
  1. soft object regions: a 1x1 ConvNormAct (`aux_conv`, as wide as the
     features) and a biased 1x1 class conv (`aux_cls`). They weight the
     gather, so every OCRNet has them; `aux=True` also returns them from a
     train-mode forward.
  2. the spatial gather: the region logits' softmax over the PIXELS in f32,
     cast to the compute dtype, weight-sums the 3x3 ConvNormAct pixel
     features (`bottleneck`, `ocr_channels`) into one vector a class,
     [B, K, C]. The region tensor runs through 1x1 ConvNormActs as the NCHW
     map [B, C, K, 1], so in train mode their BatchNorm takes its
     statistics over the batch and the K regions, as the JAX module's on
     [B, K, 1, C].
  3. object attention: two 1x1 ConvNormActs each for the query (on the
     pixels) and the key (on the regions), one for the value, all to
     `key_channels`; the similarity in f32 (query and key cast up), the
     softmax of sim * key_channels**-0.5 over the K regions, the attention
     cast down for the context product; `out_project`, then `fuse` on
     concat(context, pixels).
  4. `cls_conv` (1x1, biased), and with `full_res_output` a x4 bilinear
     upsample (align_corners=False), the region logits too in train mode
     with aux.

The products are plain `torch.bmm`: the JAX module's einsums run outside
any kernel.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn as nn

from ..nn.blocks import ConvNormAct, conv2d
from ..ops.resize import resize_bilinear_nchw
from .hrnet import HRNet

__all__ = ["OCRNet"]


class OCRNet(nn.Module):
    output_stride = 4  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, ocr_channels: int = 512,
                 key_channels: int = 256,
                 num_branches_list: Sequence[int] = (2, 3, 4),
                 base_channels: int = 32, dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, aux: bool = False,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        self.num_classes = num_classes
        self.key_channels = key_channels
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.aux = aux
        self.backbone = HRNet(num_classes=1,
                              num_branches_list=num_branches_list,
                              base_channels=base_channels, dtype=dtype,
                              feature_output=True)
        feat = self.backbone.out_channels
        oc, kc = ocr_channels, key_channels
        self.aux_conv = ConvNormAct(feat, feat, 1, dtype=dtype)
        self.aux_cls = nn.Conv2d(feat, num_classes, 1, bias=True)
        self.bottleneck = ConvNormAct(feat, oc, 3, dtype=dtype)
        self.query0 = ConvNormAct(oc, kc, 1, dtype=dtype)
        self.query1 = ConvNormAct(kc, kc, 1, dtype=dtype)
        self.key0 = ConvNormAct(oc, kc, 1, dtype=dtype)
        self.key1 = ConvNormAct(kc, kc, 1, dtype=dtype)
        self.value = ConvNormAct(oc, kc, 1, dtype=dtype)
        self.out_project = ConvNormAct(kc, oc, 1, dtype=dtype)
        self.fuse = ConvNormAct(2 * oc, oc, 1, dtype=dtype)
        self.cls_conv = nn.Conv2d(oc, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor):
        """x: [B, 3, H, W] float, H and W multiples of 32 -> logits
        [B, K, H/4, W/4] in the compute dtype (or [B, K, H, W] with
        full_res_output); with aux in train mode (logits, region logits),
        the two at the same size."""
        feats = self.backbone(x)
        dt = self.dtype
        aux_logits = conv2d(self.aux_cls, self.aux_conv(feats), dt)
        pix = self.bottleneck(feats)
        b, c, h, w = pix.shape
        k, kc = self.num_classes, self.key_channels
        # the gather: the softmax over the pixels, then [B, K, P] x [B, P, C]
        probs = torch.softmax(aux_logits.float().reshape(b, k, h * w), dim=2)
        regions = torch.bmm(probs.to(pix.dtype),
                            pix.reshape(b, c, h * w).transpose(1, 2))
        regions4 = regions.transpose(1, 2).reshape(b, c, k, 1)
        q = self.query1(self.query0(pix)).reshape(b, kc, h * w)
        kk = self.key1(self.key0(regions4)).reshape(b, kc, k)
        v = self.value(regions4).reshape(b, kc, k)
        sim = torch.bmm(q.float().transpose(1, 2), kk.float())   # [B, P, K]
        attn = torch.softmax(sim * kc ** -0.5, dim=-1)
        ctx = torch.bmm(attn.to(pix.dtype), v.transpose(1, 2))   # [B, P, kc]
        ctx = ctx.transpose(1, 2).reshape(b, kc, h, w)
        y = self.fuse(torch.cat([self.out_project(ctx), pix], dim=1))
        y = conv2d(self.cls_conv, y, dt)
        train_aux = self.aux and self.training
        if self.full_res_output:
            y = resize_bilinear_nchw(y, (4 * h, 4 * w),
                                     align_corners=self.up_align_corners)
            if train_aux:
                aux_logits = resize_bilinear_nchw(
                    aux_logits, (4 * h, 4 * w),
                    align_corners=self.up_align_corners)
        if train_aux:
            return y, aux_logits
        return y
