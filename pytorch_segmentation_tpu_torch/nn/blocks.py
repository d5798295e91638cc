"""Core blocks (port of pytorch_segmentation_tpu/nn/blocks.py, default path).

ConvNormAct == Conv2d(bias=False) + BatchNorm2d + activation. Parameters are
f32; activations run in the module's compute dtype (bf16 for serving). The
casts sit where the JAX modules put them, written out instead of
`torch.autocast`, whose cast points differ:

  - the conv casts its input and its kernel to the compute dtype;
  - BatchNorm folds its statistics (the running ones in eval mode, the
    batch's in train mode) into one scale and shift in f32 and applies them
    in the compute dtype.

`Linear` (flax `Dense`), `LayerNorm` (flax `LayerNorm`, eps 1e-6 unless
told otherwise) and `GroupNorm` (flax `GroupNorm`, eps 1e-5) keep the same
cast points: the product in the compute dtype with its bias added after the
rounding, the moments and the affine in f32. `Scale` is a learned
per-channel scale (DANet's residual gates, SegNeXt's layer scales) and
`raw_conv` a biased convolution of any (kh, kw) kernel with symmetric
k // 2 padding (SegNeXt's strip convolutions).

Padding is symmetric, dilation*(k-1)//2, as in the JAX package. The JAX
module's dot-1x1 switch (`set_conv1x1_dot`) is not ported.

int8 quantization (`quant.py`; `set_quant_mode`): a ConvNormAct with
groups == 1 records its input's abs-max ("calib"), runs its convolution as
an exact int8 product with an f32 rescale ("int8", "int8dyn", eval mode
only) or on straight-through fake-quantized operands ("qat", train mode
only). The mode belongs to the calling thread, so a quantized forward on
one thread leaves a bf16 forward on another alone. The folded path stays
unquantized, as the JAX package's `ConvStatsFolded` does.

The folded path (opt-in, `set_force_fused_1x1("on")`; the JAX package's
`BatchNormFolded` and `ConvStatsFolded`) lives on the same modules and the
same state_dict: `BatchNorm2d.fold` turns column sums into the per-channel
(scale, shift) for the CONSUMER to apply, and `ConvNormAct.folded` carries a
raw convolution output plus that fold from layer to layer, so a model flips
between the two paths on the same weights.
"""

from __future__ import annotations

import threading
from collections.abc import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8 import int8_conv2d
from ..ops.kernels.fused_matmul_bn import fused_bn_act_matmul
from ..parallel.mesh import batch_mean, batch_world

__all__ = ["BatchNorm2d", "ConvNormAct", "GroupNorm", "LayerNorm", "Linear",
           "Scale", "SeparableConvNormAct", "conv2d", "nhwc_conv",
           "raw_conv", "BN_MOMENTUM",
           "set_force_fused_1x1", "fused_1x1_available",
           "apply_fold", "QUANT_MODES", "set_quant_mode", "get_quant_mode",
           "get_quant_stats", "set_quant_min_k", "get_quant_min_k",
           "quantize_symmetric", "int8_operands"]

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


# int8 quantization mode, per thread:
#   None      - the plain path
#   "calib"   - the plain path, each eligible conv's input abs-max recorded
#               as a running max into the thread's statistics mapping
#   "int8"    - per-out-channel int8 weights x per-tensor int8 activations
#               (the scale from the calibrated statistic) -> an exact int32
#               product -> f32 rescale; BN (running statistics) and the
#               activation unchanged
#   "int8dyn" - the same with the live batch's abs-max as the scale
#   "qat"     - quantization-aware training: straight-through fake quant of
#               the conv's input and kernel with int8dyn's scales; train
#               mode only (the three modes above are eval mode only)
QUANT_MODES = (None, "calib", "int8", "int8dyn", "qat")
_QUANT = threading.local()

# The int8 gate: only convs whose contraction K = kh*kw*Cin is at least this
# are quantized (int8, int8dyn, qat); calibration records every eligible
# conv whatever the gate says. The JAX package's value, process-wide.
_QUANT_MIN_K = 576

# The scales as the JAX package's compiled program forms them: XLA turns
# `m / 127.0` into `m * f32(1/127)` and folds s_x * s_w into
# max_w * (max_x * f32(1/127)^2). With these constants the port's int8 path
# gives the compiled program's bits (an op-by-op JAX evaluation differs from
# it by one ulp in places).
_INV_127 = float(np.float32(1.0 / 127.0))
_INV_127_SQ = float(np.float32(np.float32(_INV_127) * np.float32(_INV_127)))


def set_quant_mode(mode, stats=None) -> None:
    """Set the calling thread's quantization mode (one of QUANT_MODES) and
    its statistics: a dict ConvNormAct -> f32 0-d tensor, read in "int8"
    and written in "calib". Other threads keep theirs."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode must be one of {QUANT_MODES}, not "
                         f"{mode!r}")
    _QUANT.mode = mode
    _QUANT.stats = stats


def get_quant_mode():
    return getattr(_QUANT, "mode", None)


def get_quant_stats():
    return getattr(_QUANT, "stats", None)


def set_quant_min_k(min_k: int) -> None:
    """Set the int8 gate (process-wide)."""
    global _QUANT_MIN_K
    _QUANT_MIN_K = int(min_k)


def get_quant_min_k() -> int:
    return _QUANT_MIN_K


def quantize_symmetric(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(v / scale), -127, 127) in f32 (round half to even, as
    jnp.round); the int8 values the JAX package's quantize gives."""
    return torch.clamp(torch.round(v / scale), -127.0, 127.0)


def _weight_max(w: torch.Tensor) -> torch.Tensor:
    """Per-out-channel max|w| over (I, H, W) of OIHW, at least 1e-8,
    [O, 1, 1, 1] f32: 127 times the symmetric weight scale."""
    return torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-8).view(
        -1, 1, 1, 1)


def int8_operands(x: torch.Tensor, weight: torch.Tensor,
                  amax: torch.Tensor):
    """The int8 branch's operands: x [B, Cin, H, W] quantized per tensor
    with the abs-max `amax` (f32 0-d), the OIHW f32 `weight` per out
    channel, and the f32 rescale [1, Cout, 1, 1] that turns their int32
    product into the conv's output."""
    x_max = torch.clamp(amax, min=1e-6)
    x_q = quantize_symmetric(x.float(), x_max * _INV_127).to(torch.int8)
    w_max = _weight_max(weight)
    w_q = quantize_symmetric(weight, w_max * _INV_127).to(torch.int8)
    return x_q, w_q, w_max.view(1, -1, 1, 1) * (x_max * _INV_127_SQ)


def apply_fold(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The explicit BN-apply of a fold on an NCHW tensor, in `dtype`: the
    same multiply and add as `BatchNorm2d.forward`."""
    shape = (1, -1, 1, 1)
    return (x.to(dtype) * scale.to(dtype).view(shape)
            + shift.to(dtype).view(shape))


def _pad(kernel_size: int, dilation: int) -> int:
    return dilation * (kernel_size - 1) // 2


def raw_conv(in_channels: int, out_channels: int, kernel_size,
             stride: int = 1, groups: int = 1) -> nn.Conv2d:
    """A biased convolution (torch's Conv2d default, the JAX package's raw
    `nn.Conv` with same-padding) of an int or (kh, kw) kernel, padded
    (kh // 2, kw // 2) on both sides; run it through `conv2d`."""
    kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else kernel_size)
    return nn.Conv2d(in_channels, out_channels, (kh, kw), stride=stride,
                     padding=(kh // 2, kw // 2), groups=groups, bias=True)


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


def nhwc_conv(conv: nn.Conv2d, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """`conv2d` of an NHWC tensor, through its NCHW view (channels_last
    strides); NHWC out. The ConvNeXt and Swin trunks run on NHWC tensors,
    as the JAX modules do."""
    return conv2d(conv, x.permute(0, 3, 1, 2), dtype).permute(0, 2, 3, 1)


class Linear(nn.Linear):
    """flax `Dense` on the last axis: the input and the weight `(out, in)`
    cast to `dtype`, the product rounded to `dtype`, then the bias (where
    `bias=True`) added in `dtype`. Not `F.linear(x, w, b)`, whose fused
    epilogue adds the bias before the one rounding."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """flax `LayerNorm(epsilon=eps)` over the LAST axis (eps 1e-6 by
    default; Swin's are 1e-5): the moments in f32 from the compute-dtype
    input (the fast variance max(E[x^2] - E[x]^2, 0)), the f32 weight and
    bias applied in f32, the result cast to `dtype`. The transformers
    normalize (B, N, C) tokens or NHWC maps, the channels-last view of NCHW
    ones, so C is the last axis wherever it is used."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-6):
        super().__init__(num_features, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True)
               - mean * mean).clamp(min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """flax `GroupNorm(num_groups, epsilon=eps)` on an NCHW map: the groups
    are runs of consecutive channels; each (sample, group)'s moments in f32
    from the compute-dtype input (flax's `force_float32_reductions`, the
    fast variance max(E[x^2] - E[x]^2, 0)), the normalize and the f32
    weight and bias in f32, the result cast to `dtype`."""

    def __init__(self, num_groups: int, num_channels: int,
                 dtype: torch.dtype = torch.bfloat16, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float()
        grouped = xf.reshape(b, g, -1)
        mean = grouped.mean(dim=-1, keepdim=True)
        var = ((grouped * grouped).mean(dim=-1, keepdim=True)
               - mean * mean).clamp(min=0.0)
        inv = torch.rsqrt(var + self.eps)
        shape = (b, c) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(c // g, dim=1).view(shape)
        mul = (inv.repeat_interleave(c // g, dim=1).view(shape)
               * self.weight.view((1, c) + shape[2:]))
        y = (xf - mean) * mul + self.bias.view((1, c) + shape[2:])
        return y.to(self.compute_dtype)


class Scale(nn.Module):
    """A learned per-channel scale (the JAX package's `_Scale`: a parameter
    named `scale` of shape (dim,), initialised to `init`) applied to an
    NCHW map in the map's dtype."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.scale = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale.to(x.dtype).view(1, -1, 1, 1) * x


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's semantics: the statistics are folded
    into scale and shift in f32 and applied in `dtype`. State-dict names are
    torch's (weight, bias, running_mean, running_var, num_batches_tracked).

    In train mode the statistics are the batch's, taken in f32 from the
    compute-dtype input with the one-pass variance max(E[x^2] - E[x]^2, 0);
    gradients flow through them. The running statistics move with momentum
    0.1 towards the batch mean and the unbiased batch variance (the
    normalization itself uses the biased one), outside the graph, and
    `num_batches_tracked` advances by one. Inside
    `parallel.mesh.batch_statistics_over(group)` (the train step under a
    mesh) E[x] and E[x^2] are the means over the group's ranks, through an
    all-reduce that autograd sees, and the running variance's Bessel factor
    counts every rank's values: the statistics of the global batch, as the
    JAX module's under pjit or with `axis_name`. Its `stat_subsample` is not
    ported."""

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
        parameters, buffers, running update and sums over a mesh's ranks
        as `forward`."""
        if self.training:
            mean, ex2 = batch_mean(col_sum / n, col_sumsq / n)
            return self._fold_moments(mean, ex2, n * batch_world())
        return self._fold_moments(None, None, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = ex2 = None
        n = x.numel() // x.shape[1]
        if self.training:
            xf = x.float()
            mean, ex2 = batch_mean(xf.mean(dim=(0, 2, 3)),
                                   (xf * xf).mean(dim=(0, 2, 3)))
            n *= batch_world()
        inv, shift = self._fold_moments(mean, ex2, n)
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
        mode = self._quant_mode(x)
        if mode is None:
            y = conv2d(self.conv, x, self.dtype)
        elif mode == "qat":
            y = self._fake_quant_conv(x)
        else:
            y = self._int8_conv(x, mode)
        x = self.bn(y)
        if self.activate is not None:
            x = self.activate(x)
        return x

    def _quant_mode(self, x: torch.Tensor):
        """The thread's quant mode as it applies to this conv: grouped convs
        take no part, "qat" applies in train mode and the other modes in
        eval mode, and the gate turns int8, int8dyn and qat off below
        `_QUANT_MIN_K`. "calib" records the input's abs-max here and runs
        the plain conv."""
        mode = get_quant_mode()
        if (mode is None or self.conv.groups != 1
                or (mode == "qat") != self.training):
            return None
        if mode == "calib":
            stats = get_quant_stats()
            amax = x.detach().abs().amax().float()
            if self in stats:
                amax = torch.maximum(stats[self], amax)
            stats[self] = amax
            return None
        k = self.conv.kernel_size[0]
        if k * k * self.conv.in_channels < _QUANT_MIN_K:
            return None
        return mode

    def _int8_conv(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        """The serving branch: int8 activations (per-tensor scale from the
        calibrated statistic, or the live abs-max) times int8 weights
        (per-out-channel), an exact int32 product, then one f32 multiply by
        s_x * s_w and a cast to the compute dtype."""
        conv = self.conv
        if mode == "int8":
            stats = get_quant_stats()
            if stats is None or self not in stats:
                raise KeyError("int8 mode needs a calibrated statistic for "
                               "every quantized ConvNormAct (quant."
                               "calibrate)")
            amax = stats[self]
        else:
            amax = x.abs().amax().float()
        x_q, w_q, rescale = int8_operands(x, conv.weight, amax)
        y = int8_conv2d(x_q, w_q, conv.stride[0], conv.padding[0],
                        conv.dilation[0])
        return (y.float() * rescale).to(self.dtype)

    def _fake_quant_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The QAT branch: the conv's input and kernel fake-quantized with
        int8dyn's scales (detached), the rounding passed straight through
        (STE: v + (v_dq - v).detach()), and the conv in the compute dtype
        on the fake-quantized operands."""
        conv = self.conv
        xf = x.float()
        s_x = torch.clamp(xf.detach().abs().amax(), min=1e-6) * _INV_127
        x_dq = quantize_symmetric(xf, s_x) * s_x
        xf = xf + (x_dq - xf).detach()
        kernel = conv.weight
        s_w = _weight_max(kernel.detach()) * _INV_127
        w_dq = quantize_symmetric(kernel, s_w) * s_w
        w = kernel + (w_dq - kernel).detach()
        return F.conv2d(xf.to(self.dtype), w.to(self.dtype), None,
                        conv.stride, conv.padding, conv.dilation)

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
