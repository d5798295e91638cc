"""BiSeNetV2, NCHW (port of pytorch_segmentation_tpu/models/bisenetv2.py;
Yu et al., IJCV 2021, mmseg module conventions, alpha = 1 widths). Trains
from scratch: no backbone of its own.

  - Detail branch: eight 3x3 ConvNormActs (64, 64, 128 channels), stride 8.
  - Semantic branch: the stem (a stride-2 3x3 ConvNormAct to 16 channels,
    then a strided-conv path beside a 3x3 stride-2 max-pool path, padded
    with -inf, concatenated and fused; stride 4), gather-and-expansion
    layers (`_GELayer`) to 32, 64 and 128 channels at strides 8, 16 and 32,
    and the context embedding: the global mean in f32, the lone BatchNorm
    `ce_bn` on [B, C, 1, 1] (its train-mode statistics over the batch
    alone), a 1x1 ConvNormAct added back over H and W, a 3x3 ConvNormAct.
  - Bilateral guided aggregation: each branch gates the other through a
    sigmoid taken in f32, at stride 8 and at stride 32 (the detail side
    there through a 3x3 average pool whose padded zeros count, as flax's
    `avg_pool` counts them); the stride-32 product resized up, the sum
    fused by a 3x3 ConvNormAct.
  - Head: a 3x3 ConvNormAct to `head_channels`, a biased 1x1 class conv,
    and with `full_res_output` a x8 bilinear upsample (align_corners=False).
  - Booster (aux=True): four FCN heads (`aux2`..`aux5`: a 3x3 ConvNormAct
    to `aux_channels[i]` and a biased 1x1 class conv) on the semantic taps
    at strides 4, 8, 16 and 32, each resized onto the main logits' grid
    with `up_align_corners`; a train-mode forward returns (logits, (aux2,
    aux3, aux4, aux5)), an eval-mode one the logits alone and does not run
    the heads.

The expansion of a gather-and-expansion layer is a grouped 3x3 convolution
with `groups = cin` and 6 * cin outputs: output channel j reads input
channel j // 6, as flax's `feature_group_count` groups them. `remat=True`
recomputes each gather-and-expansion layer in the backward
(`nn.blocks.checkpoint`).
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import BatchNorm2d, ConvNormAct, checkpoint, conv2d
from ..ops.resize import resize_bilinear_nchw

__all__ = ["BiSeNetV2"]


def _cna(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
         act: Callable | None = F.relu, dtype=torch.bfloat16) -> ConvNormAct:
    return ConvNormAct(cin, cout, k, stride=stride, groups=groups,
                       activate=act, dtype=dtype)


class _GELayer(nn.Module):
    """Gather-and-expansion layer (mmseg GELayer): a 3x3 gather
    ConvNormAct, the depthwise 3x3 expansion to `expand` * cin (two of them,
    the first strided and without activation, when stride 2), a linear 1x1
    projection, the residual (a depthwise-separable shortcut when strided)
    and a ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1, expand: int = 6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = cin * expand
        self.stride = stride
        self.conv1 = _cna(cin, cin, 3, dtype=dtype)
        if stride == 1:
            self.dwconv = _cna(cin, mid, 3, groups=cin, dtype=dtype)
        else:
            self.dwconv1 = _cna(cin, mid, 3, stride=stride, groups=cin,
                                act=None, dtype=dtype)
            self.dwconv2 = _cna(mid, mid, 3, groups=mid, dtype=dtype)
            self.short_dw = _cna(cin, cin, 3, stride=stride, groups=cin,
                                 act=None, dtype=dtype)
            self.short_pw = _cna(cin, cout, 1, act=None, dtype=dtype)
        self.conv2 = _cna(mid, cout, 1, act=None, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        if self.stride == 1:
            y = self.dwconv(y)
            identity = x
        else:
            y = self.dwconv2(self.dwconv1(y))
            identity = self.short_pw(self.short_dw(x))
        return F.relu(self.conv2(y) + identity)


class BiSeNetV2(nn.Module):
    output_stride = 8  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, detail_channels=(64, 64, 128),
                 semantic_channels=(16, 32, 64, 128), expand: int = 6,
                 head_channels: int = 1024,
                 aux_channels=(16, 64, 256, 1024),
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, remat: bool = False,
                 aux: bool = False,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        self.remat = remat
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.aux = aux
        c1, c2, c3 = detail_channels
        s1, s3, s4, s5 = semantic_channels

        def cna(name, cin, cout, k, **kw):
            self.add_module(name, _cna(cin, cout, k, dtype=dtype, **kw))

        def ge(name, cin, cout, stride=1):
            self.add_module(name, _GELayer(cin, cout, stride, expand, dtype))

        # the detail branch, stride 8
        for name, cin, cout, stride in (
                ("detail1_0", 3, c1, 2), ("detail1_1", c1, c1, 1),
                ("detail2_0", c1, c2, 2), ("detail2_1", c2, c2, 1),
                ("detail2_2", c2, c2, 1), ("detail3_0", c2, c3, 2),
                ("detail3_1", c3, c3, 1), ("detail3_2", c3, c3, 1)):
            cna(name, cin, cout, 3, stride=stride)
        self._detail = ("detail1_0", "detail1_1", "detail2_0", "detail2_1",
                        "detail2_2", "detail3_0", "detail3_1", "detail3_2")
        # the semantic branch
        cna("stem_conv", 3, s1, 3, stride=2)
        cna("stem_left0", s1, s1 // 2, 1)
        cna("stem_left1", s1 // 2, s1, 3, stride=2)
        cna("stem_fuse", 2 * s1, s1, 3)
        ge("ge3_0", s1, s3, 2)
        ge("ge3_1", s3, s3)
        ge("ge4_0", s3, s4, 2)
        ge("ge4_1", s4, s4)
        ge("ge5_0", s4, s5, 2)
        for i in range(1, 4):
            ge(f"ge5_{i}", s5, s5)
        self.ce_bn = BatchNorm2d(s5, dtype=dtype)
        cna("ce_conv", s5, s5, 1)
        cna("ce_fuse", s5, s5, 3)
        # bilateral guided aggregation
        cna("bga_d_dw", c3, c3, 3, groups=c3, act=None)
        self.bga_d_pw = nn.Conv2d(c3, c3, 1, bias=False)
        cna("bga_d_down", c3, c3, 3, stride=2, act=None)
        cna("bga_s_conv", s5, c3, 3, act=None)
        cna("bga_s_dw", s5, c3, 3, groups=c3, act=None)
        self.bga_s_pw = nn.Conv2d(c3, c3, 1, bias=False)
        cna("bga_fuse", c3, c3, 3)
        # the head
        cna("head", c3, head_channels, 3)
        self.cls_conv = nn.Conv2d(head_channels, num_classes, 1, bias=True)
        if aux:
            for i, (cin, mid) in enumerate(zip((s1, s3, s4, s5),
                                               aux_channels)):
                cna(f"aux{i + 2}_conv", cin, mid, 3)
                self.add_module(f"aux{i + 2}_cls",
                                nn.Conv2d(mid, num_classes, 1, bias=True))

    def _semantic(self, x: torch.Tensor):
        """The semantic branch: its output at stride 32 after the context
        embedding, and the four taps for the booster heads."""
        s = self.stem_conv(x)
        a = self.stem_left1(self.stem_left0(s))
        b = F.max_pool2d(s, 3, stride=2, padding=1)
        s = self.stem_fuse(torch.cat([a, b], dim=1))
        taps = [s]
        for names in (("ge3_0", "ge3_1"), ("ge4_0", "ge4_1"),
                      ("ge5_0", "ge5_1", "ge5_2", "ge5_3")):
            for name in names:
                layer = getattr(self, name)
                s = checkpoint(layer, s) if self.remat else layer(s)
            taps.append(s)
        g = s.float().mean(dim=(2, 3), keepdim=True)
        g = self.ce_conv(self.ce_bn(g.to(self.dtype)))
        return self.ce_fuse(s + g), taps

    def _bga(self, d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        size = tuple(d.shape[2:])
        d_a = conv2d(self.bga_d_pw, self.bga_d_dw(d), dt)
        d_b = F.avg_pool2d(self.bga_d_down(d), 3, stride=2, padding=1,
                           count_include_pad=True)
        s_a = resize_bilinear_nchw(self.bga_s_conv(s), size,
                                   align_corners=False)
        s_b = conv2d(self.bga_s_pw, self.bga_s_dw(s), dt)
        left = d_a * torch.sigmoid(s_a.float()).to(d_a.dtype)
        right = d_b * torch.sigmoid(s_b.float()).to(d_b.dtype)
        right = resize_bilinear_nchw(right, size, align_corners=False)
        return self.bga_fuse(left + right)

    def forward(self, x: torch.Tensor):
        """x: [B, 3, H, W] float, H and W multiples of 32 -> logits
        [B, K, H/8, W/8] in the compute dtype (or [B, K, H, W] with
        full_res_output); with aux in train mode (logits, (aux2, aux3, aux4,
        aux5)), each aux on the logits' grid."""
        d = x
        for name in self._detail:
            d = getattr(self, name)(d)
        s, taps = self._semantic(x)
        y = self.head(self._bga(d, s))
        y = conv2d(self.cls_conv, y, self.dtype)
        if self.full_res_output:
            y = resize_bilinear_nchw(y, (8 * y.shape[2], 8 * y.shape[3]),
                                     align_corners=self.up_align_corners)
        if not (self.aux and self.training):
            return y
        size = tuple(y.shape[2:])
        auxs = []
        for i, tap in enumerate(taps):
            a = conv2d(getattr(self, f"aux{i + 2}_cls"),
                       getattr(self, f"aux{i + 2}_conv")(tap), self.dtype)
            if tuple(a.shape[2:]) != size:
                a = resize_bilinear_nchw(a, size,
                                         align_corners=self.up_align_corners)
            auxs.append(a)
        return y, tuple(auxs)
