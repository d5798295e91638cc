"""MobileNetV2 feature extractor, NCHW (port of pytorch_segmentation_tpu/
nn/backbones/mobilenetv2.py).

Returns 5 feature taps (x1, x2, x3, x4, x) with channels 16/24/32/96/1280
at strides 2/4/8/16/32, the skip connections UNet consumes. Submodules are
named like the flax tree (`stem`, `stage{s}_block{b}` with `expand`,
`depthwise` and `project`, `head`), so the JAX package's weights load by
name.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..blocks import ConvNormAct, apply_fold, fused_1x1_available

__all__ = ["MobileNetV2", "InvertedResidual", "MOBILENETV2_TAP_CHANNELS",
           "relu6"]

MOBILENETV2_TAP_CHANNELS = (16, 24, 32, 96, 1280)

# (expand_ratio t, channels c, repeats n, stride s): standard MobileNetV2
_INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


class InvertedResidual(nn.Module):
    """1x1 expand (absent at expand_ratio 1) -> 3x3 depthwise (stride) ->
    1x1 project without activation, plus the residual where the shapes
    allow.

    With `nn.blocks.set_force_fused_1x1("on")` and an expand, the block
    takes the folded chain, as `Bottleneck` does: `expand` and `project`
    run one fused pass each (the previous BN-apply + activation in the
    product's prologue, this BN's statistics in its epilogue) and
    `depthwise` applies its input's fold explicitly. Same math, same
    parameters and buffers."""

    def __init__(self, in_channels: int, features: int, stride: int,
                 expand_ratio: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.use_residual = stride == 1 and in_channels == features
        self.expand = (ConvNormAct(in_channels, hidden, 1, activate=relu6,
                                   dtype=dtype)
                       if expand_ratio != 1 else None)
        self.depthwise = ConvNormAct(hidden, hidden, 3, stride=stride,
                                     groups=hidden, activate=relu6,
                                     dtype=dtype)
        self.project = ConvNormAct(hidden, features, 1, activate=None,
                                   dtype=dtype)
        # the block's input carries no activation (project has none), so
        # expand's prologue is x * 1 + 0, exact. Not in the state_dict;
        # moved with the module, never built from host data per call
        self.register_buffer("_unit_scale", torch.ones(in_channels),
                             persistent=False)
        self.register_buffer("_unit_shift", torch.zeros(in_channels),
                             persistent=False)

    def forward(self, x):
        if fused_1x1_available() and self.expand is not None:
            y1, sc1, sh1 = self.expand.folded(x, self._unit_scale,
                                              self._unit_shift, act_in="none")
            y2, sc2, sh2 = self.depthwise.folded(y1, sc1, sh1,
                                                 act_in="relu6")
            y3, sc3, sh3 = self.project.folded(y2, sc2, sh2, act_in="relu6")
            y = apply_fold(y3, sc3, sh3, self.project.dtype)
        else:
            y = x if self.expand is None else self.expand(x)
            y = self.project(self.depthwise(y))
        if self.use_residual:
            y = y + x
        return y


class MobileNetV2(nn.Module):
    """Returns (x1, x2, x3, x4, x) taps at strides 2/4/8/16/32."""

    def __init__(self, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()

        def c(ch):
            return (max(8, int(ch * width_mult + 4) // 8 * 8)
                    if width_mult != 1.0 else ch)

        self.stem = ConvNormAct(3, c(32), 3, stride=2,
                                activate=relu6, dtype=dtype)
        self._stages: list[list[str]] = []
        cin = c(32)
        for stage_i, (t, ch, n, s) in enumerate(_INVERTED_RESIDUAL_CFG):
            names = []
            for block_i in range(n):
                name = f"stage{stage_i}_block{block_i}"
                self.add_module(name, InvertedResidual(
                    cin, c(ch), stride=s if block_i == 0 else 1,
                    expand_ratio=t, dtype=dtype))
                cin = c(ch)
                names.append(name)
            self._stages.append(names)
        self.head = ConvNormAct(cin, c(1280), 1, activate=relu6, dtype=dtype)
        self.out_channels = c(1280)

    def forward(self, x):
        x = self.stem(x)
        taps = []
        tap_after = (0, 1, 2, 4)  # cfg-stage indices whose output is a tap
        for stage_i, names in enumerate(self._stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage_i in tap_after:
                taps.append(x)
        taps.append(self.head(x))
        return tuple(taps)
