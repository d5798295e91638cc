"""MobileNetV3-Large backbone, NCHW (port of pytorch_segmentation_tpu/nn/
backbones/mobilenetv3.py; torchvision's `mobilenet_v3_large`).

A 3x3 stride-2 16-channel stem (hardswish), 15 inverted residuals from the
paper's Large table (`block0`..`block14`: 1x1 expand, absent in block 0
whose expansion equals its input; depthwise 3x3 or 5x5; squeeze-excite in
some; 1x1 project without activation; relu or hardswish), then a 1x1
960-channel hardswish `head`. `dilated=True` (the LR-ASPP configuration)
keeps block 12 at stride 1 and runs the tail at dilation 2, so the deepest
features sit at stride 16, not 32.

Squeeze-excite (`se`): the mean over the map in f32 cast back, biased 1x1
`fc1` (channels/4 rounded to 8) -> ReLU -> biased 1x1 `fc2` -> hardsigmoid
-> channel scale. hardswish and hardsigmoid are the JAX expressions
(`x * clamp(x + 3, 0, 6) * (1/6 in x's dtype)`), rounded as they round.

Returns 5 taps: 16 channels at stride 2, 24 at 4, 40 at 8, 112 at 16, and
960 at 16 (dilated) or 32. The folded 1x1 path is not taken here: the JAX
module's blocks are plain ConvNormAct.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..blocks import ConvNormAct, conv2d

__all__ = ["MobileNetV3", "MOBILENETV3_LARGE_CFG", "hardswish",
           "hardsigmoid"]


@functools.lru_cache(maxsize=None)
def _sixth(dtype: torch.dtype) -> float:
    """1/6 rounded to `dtype`, as the Python float a multiply takes: bf16
    inputs then see bf16(1/6), as in JAX (1/6 itself would be applied at
    f32 precision), and the product of two bf16 values is exact in f32
    before its one rounding."""
    return float(torch.tensor(1 / 6, dtype=dtype))


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return (x + 3.0).clamp(0.0, 6.0) * _sixth(x.dtype)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * (x + 3.0).clamp(0.0, 6.0) * _sixth(x.dtype)


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (kernel, expanded, out, use_se, use_hs, stride): torchvision
# mobilenet_v3_large's rows (features.1..15)
MOBILENETV3_LARGE_CFG = (
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
)


class _SqueezeExcite(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        squeeze = _make_divisible(channels // 4)
        self.dtype = dtype
        self.fc1 = nn.Conv2d(channels, squeeze, 1, bias=True)
        self.fc2 = nn.Conv2d(squeeze, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = F.relu(conv2d(self.fc1, s, self.dtype))
        return x * hardsigmoid(conv2d(self.fc2, s, self.dtype))


class _InvertedResidualV3(nn.Module):
    def __init__(self, in_channels: int, kernel: int, expanded: int,
                 features: int, use_se: bool, use_hs: bool, stride: int,
                 dilation: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        act = hardswish if use_hs else F.relu
        self.expand = (ConvNormAct(in_channels, expanded, 1, activate=act,
                                   dtype=dtype)
                       if expanded != in_channels else None)
        self.depthwise = ConvNormAct(expanded, expanded, kernel,
                                     stride=stride, dilation=dilation,
                                     groups=expanded, activate=act,
                                     dtype=dtype)
        self.se = _SqueezeExcite(expanded, dtype) if use_se else None
        self.project = ConvNormAct(expanded, features, 1, activate=None,
                                   dtype=dtype)
        self.use_residual = stride == 1 and in_channels == features

    def forward(self, x):
        y = x if self.expand is None else self.expand(x)
        y = self.depthwise(y)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        if self.use_residual:
            y = y + x
        return y


class MobileNetV3(nn.Module):
    """MobileNetV3-Large feature trunk; returns the 5 taps (see the
    module's docstring)."""

    def __init__(self, dilated: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stem = ConvNormAct(3, 16, 3, stride=2, activate=hardswish,
                                dtype=dtype)
        cin, dilation = 16, 1
        for i, (k, exp, out, se, hs, s) in enumerate(MOBILENETV3_LARGE_CFG):
            if dilated and i == 12:
                # the would-be stride-2 block keeps stride 1 and the tail
                # runs at dilation 2 (torchvision dilated=True)
                dilation, s = 2, 1
            self.add_module(f"block{i}", _InvertedResidualV3(
                cin, k, exp, out, se, hs, s, dilation=dilation, dtype=dtype))
            cin = out
        self.head = ConvNormAct(cin, 960, 1, activate=hardswish, dtype=dtype)

    def forward(self, x):
        x = self.stem(x)
        taps = []
        for i in range(len(MOBILENETV3_LARGE_CFG)):
            x = getattr(self, f"block{i}")(x)
            if i in (0, 2, 5, 11):   # 16 @ s2, 24 @ s4, 40 @ s8, 112 @ s16
                taps.append(x)
        taps.append(self.head(x))
        return tuple(taps)
