"""Core blocks (port of pytorch_segmentation_tpu/nn/blocks.py, default path).

ConvNormAct == Conv2d(bias=False) + BatchNorm2d + activation. Parameters are
f32; activations run in the module's compute dtype (bf16 for serving). The
casts sit where the JAX modules put them, written out instead of
`torch.autocast`, whose cast points differ:

  - the conv casts its input and its kernel to the compute dtype;
  - BatchNorm folds its statistics (the running ones in eval mode, the
    batch's in train mode) into one scale and shift in f32 and applies them
    in the compute dtype.

Padding is symmetric, dilation*(k-1)//2, as in the JAX package. The int8,
quantization-aware, fused-1x1 and dot-1x1 branches of the JAX module are not
ported yet.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BatchNorm2d", "ConvNormAct", "conv2d", "BN_MOMENTUM"]

BN_MOMENTUM = 0.1  # torch convention


def _pad(kernel_size: int, dilation: int) -> int:
    return dilation * (kernel_size - 1) // 2


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run `conv`'s geometry with input, kernel and bias cast to `dtype`."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's semantics: the statistics are folded
    into scale and shift in f32 and applied in `dtype`. State-dict names are
    torch's (weight, bias, running_mean, running_var, num_batches_tracked).

    In train mode the statistics are the batch's, taken in f32 from the
    compute-dtype input with the one-pass variance max(E[x^2] - E[x]^2, 0);
    gradients flow through them. The running statistics move with momentum
    0.1 towards the batch mean and the unbiased batch variance (the
    normalization itself uses the biased one), outside the graph, and
    `num_batches_tracked` advances by one. The JAX module's `stat_subsample`
    and `axis_name` (statistics across replicas) are not ported."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(num_features, eps=1e-5, momentum=BN_MOMENTUM)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            ex2 = (xf * xf).mean(dim=(0, 2, 3))
            var = (ex2 - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                n = float(x.numel() // x.shape[1])
                bessel = n / max(n - 1.0, 1.0)
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * bessel))
                self.num_batches_tracked += 1
        else:
            mean = self.running_mean.float()
            var = self.running_var.float()
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        dt = self.compute_dtype
        shape = (1, -1, 1, 1)
        return (x.to(dt) * inv.to(dt).view(shape)
                + shift.to(dt).view(shape))


class ConvNormAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d + activation (default ReLU), NCHW.
    Children are named `conv` and `bn`, like the flax module's subtrees."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 activate: Callable | None = F.relu,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              stride=stride,
                              padding=_pad(kernel_size, dilation),
                              dilation=dilation, groups=groups, bias=False)
        self.bn = BatchNorm2d(features, dtype=dtype)
        self.activate = activate
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv2d(self.conv, x, self.dtype))
        if self.activate is not None:
            x = self.activate(x)
        return x
