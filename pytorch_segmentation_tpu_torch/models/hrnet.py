"""HRNet for semantic segmentation, NCHW (port of
pytorch_segmentation_tpu/models/hrnet.py, which this mirrors rather than the
official HRNet).

Stem: two stride-2 ConvNormActs (the first without activation) and four
Bottlenecks at width 64 (256 channels out); then one HRModule a stage with
2/3/4 parallel branches (four BasicBlocks a branch, 32 * 2^i channels),
joined by transition layers and an all-to-all fuse:
  j > i: a 1x1 ConvNormAct (its ReLU kept, before the upsample) and a
         2^(j-i)x bilinear upsample, align_corners=False;
  j < i: a chain of stride-2 3x3 ConvNormActs, the last one without
         activation.
The last stage fuses into the highest-resolution branch only; a 1x1 class
conv with bias gives stride-4 logits, and with `full_res_output=True` a x4
bilinear upsample (align_corners=False) follows.

The JAX module's `feature_output=True` (the OCRNet backbone) is not ported
yet.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.backbones.resnet import BasicBlock, Bottleneck
from ..nn.blocks import ConvNormAct, conv2d
from ..ops.resize import resize_bilinear_nchw

__all__ = ["HRNet", "HRModule"]


class HRModule(nn.Module):
    """One high-resolution module: each branch's residual blocks, then the
    fuse of every branch into each output branch. Branch i arrives with
    `channels[i]` channels (the transitions see to it), so no block needs
    the JAX module's width-changing downsample."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4,
                 multi_scale_output: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_branches = len(channels)
        self.num_blocks = num_blocks
        self.num_out = self.num_branches if multi_scale_output else 1
        for i, ch in enumerate(channels):
            for b in range(num_blocks):
                self.add_module(f"branch{i}_block{b}",
                                BasicBlock(ch, ch, dtype=dtype))
        if self.num_branches == 1:
            return
        for i in range(self.num_out):
            for j in range(self.num_branches):
                if j > i:
                    self.add_module(f"fuse{i}_{j}", ConvNormAct(
                        channels[j], channels[i], 1, dtype=dtype))
                for k in range(i - j):  # j < i: the stride-2 chain
                    last = k == i - j - 1
                    self.add_module(f"fuse{i}_{j}_down{k}", ConvNormAct(
                        channels[j], channels[i] if last else channels[j],
                        3, stride=2, activate=None if last else F.relu,
                        dtype=dtype))

    def forward(self, xs):
        ys = []
        for i, y in enumerate(xs):
            for b in range(self.num_blocks):
                y = getattr(self, f"branch{i}_block{b}")(y)
            ys.append(y)
        if self.num_branches == 1:
            return ys
        fused = []
        for i in range(self.num_out):
            acc = None
            for j in range(self.num_branches):
                z = ys[j]
                if j > i:
                    z = getattr(self, f"fuse{i}_{j}")(z)
                    scale = 2 ** (j - i)
                    z = resize_bilinear_nchw(
                        z, (z.shape[2] * scale, z.shape[3] * scale),
                        align_corners=False)
                for k in range(i - j):
                    z = getattr(self, f"fuse{i}_{j}_down{k}")(z)
                acc = z if acc is None else acc + z
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    output_stride = 4  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int = 2,
                 num_branches_list: Sequence[int] = (2, 3, 4),
                 base_channels: int = 32, dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False,
                 feature_output: bool = False):
        super().__init__()
        if feature_output:
            raise NotImplementedError(
                "HRNet(feature_output=True), the OCRNet backbone, is not "
                "ported yet (ROADMAP queue 1 item 6, ocrnet)")
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.stem_conv1 = ConvNormAct(3, 64, 3, stride=2, activate=None,
                                      dtype=dtype)
        self.stem_conv2 = ConvNormAct(64, 64, 3, stride=2, dtype=dtype)
        for b in range(4):
            self.add_module(f"stem_bottleneck{b}", Bottleneck(
                64 if b == 0 else 256, 64, downsample=(b == 0), dtype=dtype))
        # per stage, per branch: the transition modules it runs through
        self._transitions: list[list[list[str]]] = []
        prev = [256]
        for s, num_branches in enumerate(num_branches_list):
            cur = [base_channels * 2 ** i for i in range(num_branches)]
            chains = []
            for i in range(num_branches):
                if i < len(prev):
                    names = []  # the branch passes through unchanged
                    if prev[i] != cur[i]:
                        names = [f"transition{s}_{i}"]
                        self.add_module(names[0], ConvNormAct(
                            prev[i], cur[i], 3, dtype=dtype))
                else:  # a new branch, strided down from the lowest one
                    names, cin = [], prev[-1]
                    for j in range(i + 1 - len(prev)):
                        out = cur[i] if j == i - len(prev) else prev[-1]
                        names.append(f"transition{s}_{i}_down{j}")
                        self.add_module(names[-1], ConvNormAct(
                            cin, out, 3, stride=2, dtype=dtype))
                        cin = out
                chains.append(names)
            self._transitions.append(chains)
            last_stage = s == len(num_branches_list) - 1
            self.add_module(f"stage{s}", HRModule(
                cur, multi_scale_output=not last_stage, dtype=dtype))
            prev = cur
        self.final_layer = nn.Conv2d(prev[0], num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] float, H and W multiples of 32 -> logits
        [B, C, H/4, W/4] in the compute dtype (or [B, C, H, W] with
        full_res_output)."""
        x = self.stem_conv2(self.stem_conv1(x))
        for b in range(4):
            x = getattr(self, f"stem_bottleneck{b}")(x)
        ys = [x]
        for s, chains in enumerate(self._transitions):
            xs = []
            for i, names in enumerate(chains):
                # an existing branch from itself, a new one from the lowest
                z = ys[i] if i < len(ys) else ys[-1]
                for name in names:
                    z = getattr(self, name)(z)
                xs.append(z)
            ys = getattr(self, f"stage{s}")(xs)
        y = conv2d(self.final_layer, ys[0], self.dtype)
        if self.full_res_output:
            y = resize_bilinear_nchw(y, (4 * y.shape[2], 4 * y.shape[3]),
                                     align_corners=False)
        return y
