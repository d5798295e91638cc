"""ASPP, Atrous Spatial Pyramid Pooling, NCHW (port of
pytorch_segmentation_tpu/models/aspp.py).

Branches: global-average-pool + 1x1 ConvNormAct broadcast back over the map
(a bilinear upsample of a 1x1 map is a broadcast); a 1x1 ConvNormAct; one
3x3 dilated ConvNormAct per atrous rate. Concat, then a 1x1 projection.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn as nn

from ..nn.blocks import ConvNormAct

__all__ = ["ASPP", "ASPPPooling"]


class ASPPPooling(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.gap_conv = ConvNormAct(in_channels, features, kernel_size=1,
                                    dtype=dtype)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        # mean in f32, cast back to the input's dtype (aspp.py:31-32)
        y = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        y = self.gap_conv(y)
        return y.expand(-1, -1, h, w)


class ASPP(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 atrous_rates: Sequence[int] = (12, 24, 36),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pool = ASPPPooling(in_channels, features, dtype=dtype)
        self.conv1x1 = ConvNormAct(in_channels, features, kernel_size=1,
                                   dtype=dtype)
        self.n_rates = len(atrous_rates)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f"atrous{i}", ConvNormAct(
                in_channels, features, kernel_size=3, dilation=rate,
                dtype=dtype))
        self.project = ConvNormAct(features * (2 + len(atrous_rates)),
                                   features, kernel_size=1, dtype=dtype)

    def forward(self, x):
        branches = [self.pool(x), self.conv1x1(x)]
        branches += [getattr(self, f"atrous{i}")(x)
                     for i in range(self.n_rates)]
        return self.project(torch.cat(branches, dim=1))
