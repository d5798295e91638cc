"""ResNet backbones, NCHW (port of pytorch_segmentation_tpu/nn/backbones/
resnet.py).

Returns the per-stage feature list [stem, layer1..layer4].
`replace_stride_with_dilation` trades a stage's stride for dilation, so
DeepLabV3+ runs at output stride 16. Submodules are named like the flax
tree (`stem`, `layer{s}_block{b}` with `conv1..3` and `downsample`), so the
JAX package's weights load by name.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..blocks import ConvNormAct, apply_fold, fused_1x1_available

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet34_cfg",
           "resnet50_cfg"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = ConvNormAct(in_channels, features, 3, stride=stride,
                                 dilation=dilation, dtype=dtype)
        self.conv2 = ConvNormAct(features, features, 3, dilation=dilation,
                                 activate=None, dtype=dtype)
        self.downsample = (ConvNormAct(in_channels, features, 1,
                                       stride=stride, activate=None,
                                       dtype=dtype)
                           if downsample else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, with the residual add.

    With `nn.blocks.set_force_fused_1x1("on")` the block takes the folded
    chain (`ConvNormAct.folded`): raw convolution outputs travel with their
    folded BN (scale, shift), `conv1` and `conv3` run as one fused pass each
    (the previous BN-apply + ReLU in the product's prologue, this BN's
    statistics in its epilogue) and `conv2` applies its input's fold
    explicitly. Same math, same parameters and buffers."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = ConvNormAct(in_channels, features, 1, dtype=dtype)
        # stride on the 3x3 (torchvision v1.5+ convention)
        self.conv2 = ConvNormAct(features, features, 3, stride=stride,
                                 dilation=dilation, dtype=dtype)
        self.conv3 = ConvNormAct(features, features * 4, 1, activate=None,
                                 dtype=dtype)
        self.downsample = (ConvNormAct(in_channels, features * 4, 1,
                                       stride=stride, activate=None,
                                       dtype=dtype)
                           if downsample else None)
        # the block's input is a ReLU's output, so relu(x * 1 + 0) is exact:
        # conv1's prologue gets this unit fold. Not in the state_dict; moved
        # with the module, never built from host data per call
        self.register_buffer("_unit_scale", torch.ones(in_channels),
                             persistent=False)
        self.register_buffer("_unit_shift", torch.zeros(in_channels),
                             persistent=False)

    def forward(self, x):
        if fused_1x1_available():
            y1, sc1, sh1 = self.conv1.folded(x, self._unit_scale,
                                             self._unit_shift)
            y2, sc2, sh2 = self.conv2.folded(y1, sc1, sh1)
            y3, sc3, sh3 = self.conv3.folded(y2, sc2, sh2)
            y = apply_fold(y3, sc3, sh3, self.conv3.dtype)
        else:
            y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Feature-list ResNet; `block` is 'basic' or 'bottleneck'."""

    def __init__(self, block: str, layers: Sequence[int],
                 replace_stride_with_dilation: Sequence[bool] = (False, False,
                                                                 False),
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        block_cls = BasicBlock if block == "basic" else Bottleneck
        # stem: 7x7/2 conv + BN + ReLU, then a 3x3/2 max-pool (pad 1, -inf)
        self.stem = ConvNormAct(in_channels, 64, kernel_size=7, stride=2,
                                dtype=dtype)
        self._stages: list[list[str]] = []
        cin = 64
        dilation = 1
        for stage_i, (width, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                        layers)):
            stride = 1 if stage_i == 0 else 2
            # torchvision _make_layer: when a stage trades stride for
            # dilation, its FIRST block keeps the previous dilation
            prev_dilation = dilation
            if stage_i > 0 and replace_stride_with_dilation[stage_i - 1]:
                dilation *= stride
                stride = 1
            names = []
            for block_i in range(n_blocks):
                downsample = block_i == 0 and (
                    stride != 1 or cin != width * block_cls.expansion)
                name = f"layer{stage_i + 1}_block{block_i}"
                self.add_module(name, block_cls(
                    cin, width, stride=stride if block_i == 0 else 1,
                    dilation=prev_dilation if block_i == 0 else dilation,
                    downsample=downsample, dtype=dtype))
                cin = width * block_cls.expansion
                names.append(name)
            self._stages.append(names)
        self.out_channels = cin

    def forward(self, x):
        x = self.stem(x)
        features = [x]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for names in self._stages:
            for name in names:
                x = getattr(self, name)(x)
            features.append(x)
        return features


def resnet34_cfg(**kw):
    return dict(block="basic", layers=(3, 4, 6, 3), **kw)


def resnet50_cfg(**kw):
    return dict(block="bottleneck", layers=(3, 4, 6, 3), **kw)
