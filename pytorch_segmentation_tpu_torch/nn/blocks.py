"""Core blocks (port of pytorch_segmentation_tpu/nn/blocks.py, default path).

ConvNormAct == Conv2d(bias=False) + BatchNorm2d + activation. Parameters are
f32; activations run in the module's compute dtype (bf16 for serving). The
casts sit where the JAX modules put them, written out instead of
`torch.autocast`, whose cast points differ:

  - the conv casts its input and its kernel to the compute dtype;
  - BatchNorm folds its statistics (the running ones in eval mode, the
    batch's in train mode) into one scale and shift in f32 and applies them
    in the compute dtype.

`Linear` (flax `Dense`) and `LayerNorm` (flax `LayerNorm`, eps 1e-6) keep
the same cast points: the product in the compute dtype with its bias added
after the rounding, the moments and the affine in f32.

Padding is symmetric, dilation*(k-1)//2, as in the JAX package. The int8,
quantization-aware and dot-1x1 branches of the JAX module are not ported
yet.

The folded path (opt-in, `set_force_fused_1x1("on")`; the JAX package's
`BatchNormFolded` and `ConvStatsFolded`) lives on the same modules and the
same state_dict: `BatchNorm2d.fold` turns column sums into the per-channel
(scale, shift) for the CONSUMER to apply, and `ConvNormAct.folded` carries a
raw convolution output plus that fold from layer to layer, so a model flips
between the two paths on the same weights.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.fused_matmul_bn import fused_bn_act_matmul

__all__ = ["BatchNorm2d", "ConvNormAct", "LayerNorm", "Linear",
           "SeparableConvNormAct", "conv2d", "BN_MOMENTUM", "set_force_fused_1x1", "fused_1x1_available",
           "apply_fold"]

BN_MOMENTUM = 0.1  # torch convention

_FORCE_FUSED_1X1 = None  # 'on' | 'off' | None = default (off)


def set_force_fused_1x1(mode) -> None:
    """None (the default: off) | 'off' | 'on' (opt-in). Read at forward time:
    ResNet bottlenecks (conv1, conv3) and MobileNetV2 inverted residuals
    with an expand (expand, project) then route their 1x1 convolutions
    through `ops/kernels/fused_matmul_bn.py` (the CUDA kernels on the card,
    their plain versions on the CPU). The JAX package's 'interpret' mode
    (its Pallas kernels on the CPU) has no meaning here."""
    global _FORCE_FUSED_1X1
    if mode not in (None, "off", "on"):
        raise ValueError(f"set_force_fused_1x1 takes None, 'off' or 'on', "
                         f"not {mode!r}")
    _FORCE_FUSED_1X1 = mode


def fused_1x1_available() -> bool:
    """Whether ResNet bottlenecks and MobileNetV2 inverted residuals take
    the folded chain. Off by default."""
    return _FORCE_FUSED_1X1 == "on"


def apply_fold(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The explicit BN-apply of a fold on an NCHW tensor, in `dtype`: the
    same multiply and add as `BatchNorm2d.forward`."""
    shape = (1, -1, 1, 1)
    return (x.to(dtype) * scale.to(dtype).view(shape)
            + shift.to(dtype).view(shape))


def _pad(kernel_size: int, dilation: int) -> int:
    return dilation * (kernel_size - 1) // 2


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run `conv`'s geometry with input, kernel and bias cast to `dtype`. The
    bias is added to the convolution's output in `dtype`, as the flax Conv
    does: in bf16 that is two roundings, which a bias inside the
    convolution would make one."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype).view(1, -1, 1, 1)
    return y


class Linear(nn.Linear):
    """flax `Dense` on the last axis: the input and the weight `(out, in)`
    cast to `dtype`, the product rounded to `dtype`, then the bias added in
    `dtype`. Not `F.linear(x, w, b)`, whose fused epilogue adds the bias
    before the one rounding."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=True)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + \
            self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """flax `LayerNorm(epsilon=1e-6)` over the LAST axis: the moments in f32
    from the compute-dtype input (the fast variance max(E[x^2] - E[x]^2,
    0)), the f32 weight and bias applied in f32, the result cast to `dtype`.
    The MiT normalizes its (B, N, C) tokens, the channels-last view of its
    NCHW maps, so C is the last axis wherever it is used."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(num_features, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True)
               - mean * mean).clamp(min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(self.compute_dtype)


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

    def _fold_moments(self, mean, ex2, n: int):
        """(scale, shift) in f32 from the batch's E[x] and E[x^2] over `n`
        values per channel (train mode, with the running update) or from the
        running statistics (eval mode; `mean` and `ex2` may then be None)."""
        if self.training:
            var = (ex2 - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                bessel = float(n) / max(float(n) - 1.0, 1.0)
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
        return inv, self.bias - mean * inv

    def fold(self, col_sum: torch.Tensor, col_sumsq: torch.Tensor, n: int):
        """BatchNorm whose batch statistics arrive as per-channel sums and
        sums of squares over `n` values (from a fused convolution's
        epilogue) instead of being reduced from the activation. Returns the
        folded (scale, shift) in f32 for the CONSUMER to apply: the
        normalize itself fuses into the next layer's prologue. Same
        parameters, buffers and running update as `forward`."""
        if self.training:
            return self._fold_moments(col_sum / n, col_sumsq / n, n)
        return self._fold_moments(None, None, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = ex2 = None
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            ex2 = (xf * xf).mean(dim=(0, 2, 3))
        inv, shift = self._fold_moments(mean, ex2, x.numel() // x.shape[1])
        return apply_fold(x, inv, shift, self.compute_dtype)


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

    def folded(self, x_raw: torch.Tensor, in_scale: torch.Tensor,
               in_shift: torch.Tensor, act_in: str = "relu"):
        """The folded path (the JAX package's `ConvStatsFolded`): consumes
        the PREVIOUS layer's raw output [B, K, H, W] with its fold
        (in_scale, in_shift) [K] f32 and nonlinearity `act_in` ('relu' |
        'relu6' | 'none'); returns this convolution's RAW output and this
        layer's folded BN (scale, shift) for the consumer. `activate` is not
        applied: it is the consumer's `act_in`.

        1x1, stride 1, groups 1: one fused pass (BN-apply + activation
        prologue, product, statistics epilogue), the hand-written kernels on
        the card. Anything else: explicit BN-apply and activation in the
        compute dtype, the convolution, and the f32 column sums by plain
        ops."""
        conv, dt = self.conv, self.dtype
        if (conv.kernel_size == (1, 1) and conv.stride == (1, 1)
                and conv.groups == 1):
            b, k, h, w = x_raw.shape
            # NHWC views: rows are contiguous when x_raw is channels_last
            y, s, ss = fused_bn_act_matmul(
                x_raw.to(dt).permute(0, 2, 3, 1), in_scale, in_shift,
                conv.weight.view(conv.out_channels, k).t(), act=act_in)
            y_raw = y.permute(0, 3, 1, 2)
            n = b * h * w
        else:
            z = apply_fold(x_raw, in_scale, in_shift, dt)
            if act_in == "relu":
                z = F.relu(z)
            elif act_in == "relu6":
                z = z.clamp(0.0, 6.0)
            elif act_in != "none":
                raise ValueError(f"act_in must be 'relu', 'relu6' or "
                                 f"'none', not {act_in!r}")
            y_raw = conv2d(conv, z, dt)
            yf = y_raw.float()
            s = yf.sum(dim=(0, 2, 3))
            ss = (yf * yf).sum(dim=(0, 2, 3))
            n = y_raw.numel() // y_raw.shape[1]
        out_scale, out_shift = self.bn.fold(s, ss, n)
        return y_raw, out_scale, out_shift


class SeparableConvNormAct(nn.Module):
    """Depthwise-separable ConvNormAct: a depthwise k x k ConvNormAct
    (`groups = in_channels`, stride, dilation) and a pointwise 1x1
    ConvNormAct, each with the activation. Children are named `depthwise`
    and `pointwise`, like the flax module's subtrees."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1,
                 activate: Callable | None = F.relu,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depthwise = ConvNormAct(in_channels, in_channels, kernel_size,
                                     stride=stride, dilation=dilation,
                                     groups=in_channels, activate=activate,
                                     dtype=dtype)
        self.pointwise = ConvNormAct(in_channels, features, 1,
                                     activate=activate, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))
