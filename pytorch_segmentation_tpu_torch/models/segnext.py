"""SegNeXt (MSCAN encoder + LightHam decoder), NCHW (port of
pytorch_segmentation_tpu/models/segnext.py; Guo et al., NeurIPS 2022, mmseg
module names).

Encoder (MSCAN): a stem of two stride-2 3x3 ConvNormActs (exact GELU, then
none), stride-2 3x3 ConvNormAct patch embeddings between the stages, and
blocks of
    x += layer_scale_1 * SpatialAttention(BN(x))
    x += layer_scale_2 * MixFFN(BN(x))
where SpatialAttention is proj_1 -> GELU -> the MSCA gate (a depthwise 5x5,
three depthwise strip pairs 1x7 / 7x1, 1x11 / 11x1, 1x21 / 21x1 summed with
it, a 1x1 mix, times its input) -> proj_2, plus its input, and MixFFN is
fc1 -> depthwise 3x3 -> GELU -> fc2; every one of these a biased raw conv.
The layer scales are `Scale` parameters `layer_scale_*.scale` (init 1e-2).
A LayerNorm (eps 1e-6, over the channels) ends each stage.

Decoder (LightHamHead): the stride-16 and stride-32 taps resized onto the
stride-8 one (align_corners=False) and concatenated; `squeeze` (1x1 conv,
GroupNorm(32), ReLU); the Hamburger (`ham_in` 1x1 biased, ReLU, `nmf2d`,
`ham_out` 1x1, GroupNorm, ReLU of the sum with its input); `align`; the
biased 1x1 class conv, whose logits are cast to f32; with
`full_res_output` a bilinear resize to the input size (align_corners=False).

`nmf2d` is the Ham paper's NMF with the one-step gradient: the multiplicative
updates (6 in train mode, 7 in eval) run without a graph in f32 from the
fixed bases `nmf_bases` (numpy RandomState(1), column-normalised: the JAX
package's in place of mmseg's per-forward random bases), and only the last
coefficient update and the reconstruction carry the gradient to the input.
The products are plain `torch.bmm`, as the JAX module's einsums run outside
any kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import (BatchNorm2d, ConvNormAct, GroupNorm, LayerNorm,
                         Scale, conv2d, raw_conv)
from ..ops.resize import resize_bilinear_nchw
from .segformer import _refuse_unported

__all__ = ["SegNeXt", "MSCAN", "MSCAN_VARIANTS", "nmf2d", "nmf_bases"]

# depths, dims, FFN ratios, decoder (Hamburger) channels, NMF rank; "tiny"
# is not a paper variant: the JAX package's test size
MSCAN_VARIANTS = {
    "tiny": ((1, 1, 1, 1), (16, 24, 32, 48), (4, 4, 2, 2), 32, 8),
    "t": ((3, 3, 5, 2), (32, 64, 160, 256), (8, 8, 4, 4), 256, 64),
    "s": ((2, 2, 4, 2), (64, 128, 320, 512), (8, 8, 4, 4), 256, 64),
    "b": ((3, 3, 12, 3), (64, 128, 320, 512), (8, 8, 4, 4), 512, 64),
}
LAYER_SCALE_INIT = 1e-2


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU with the JAX package's roundings
    (`jax.nn.gelu(approximate=False)`): 0.5 * x * erfc(-x * sqrt(0.5)),
    sqrt(0.5) rounded to x's dtype and each op rounded to it."""
    sqrt_half = float(torch.tensor(0.5 ** 0.5, dtype=x.dtype))
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


class _MSCA(nn.Module):
    """The multi-scale convolutional attention gate (mmseg MSCAAttention)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv0 = raw_conv(dim, dim, 5, groups=dim)
        for i, k in enumerate((7, 11, 21)):
            self.add_module(f"conv{i}_1", raw_conv(dim, dim, (1, k),
                                                   groups=dim))
            self.add_module(f"conv{i}_2", raw_conv(dim, dim, (k, 1),
                                                   groups=dim))
        self.conv3 = raw_conv(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        attn = conv2d(self.conv0, x, dt)
        total = attn
        for i in range(3):
            a = conv2d(getattr(self, f"conv{i}_1"), attn, dt)
            total = total + conv2d(getattr(self, f"conv{i}_2"), a, dt)
        return conv2d(self.conv3, total, dt) * x


class _SpatialAttention(nn.Module):
    """mmseg MSCASpatialAttention: proj_1 -> GELU -> MSCA -> proj_2, plus
    the input."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj_1 = raw_conv(dim, dim, 1)
        self.spatial_gating_unit = _MSCA(dim, dtype)
        self.proj_2 = raw_conv(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gelu(conv2d(self.proj_1, x, self.dtype))
        y = conv2d(self.proj_2, self.spatial_gating_unit(y), self.dtype)
        return y + x


class _Block(nn.Module):
    """MSCAN block: BN -> spatial attention (layer_scale_1), BN -> MixFFN
    (layer_scale_2), each added to the residual stream."""

    def __init__(self, dim: int, mlp_ratio: int, dtype: torch.dtype):
        super().__init__()
        hidden = dim * mlp_ratio
        self.dtype = dtype
        self.norm1 = BatchNorm2d(dim, dtype=dtype)
        self.attn = _SpatialAttention(dim, dtype)
        self.layer_scale_1 = Scale(dim, LAYER_SCALE_INIT)
        self.norm2 = BatchNorm2d(dim, dtype=dtype)
        self.fc1 = raw_conv(dim, hidden, 1)
        self.dwconv = raw_conv(hidden, hidden, 3, groups=hidden)
        self.fc2 = raw_conv(hidden, dim, 1)
        self.layer_scale_2 = Scale(dim, LAYER_SCALE_INIT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + self.layer_scale_1(self.attn(self.norm1(x)))
        h = conv2d(self.fc1, self.norm2(x), dt)
        h = gelu(conv2d(self.dwconv, h, dt))
        return x + self.layer_scale_2(conv2d(self.fc2, h, dt))


class MSCAN(nn.Module):
    """The encoder: the four stage outputs at strides 4, 8, 16 and 32."""

    def __init__(self, depths=(3, 3, 5, 2), dims=(32, 64, 160, 256),
                 mlp_ratios=(8, 8, 4, 4), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depths = tuple(depths)
        cin = 3
        for s, (depth, dim, ratio) in enumerate(zip(depths, dims,
                                                    mlp_ratios)):
            if s == 0:
                self.stem1 = ConvNormAct(3, dim // 2, 3, stride=2,
                                         activate=gelu, dtype=dtype)
                self.stem2 = ConvNormAct(dim // 2, dim, 3, stride=2,
                                         activate=None, dtype=dtype)
            else:
                self.add_module(f"embed{s}", ConvNormAct(
                    cin, dim, 3, stride=2, activate=None, dtype=dtype))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}",
                                _Block(dim, ratio, dtype))
            self.add_module(f"stage{s}_norm", LayerNorm(dim, dtype))
            cin = dim

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for s, depth in enumerate(self.depths):
            if s == 0:
                x = self.stem2(self.stem1(x))
            else:
                x = getattr(self, f"embed{s}")(x)
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            norm = getattr(self, f"stage{s}_norm")
            x = norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            taps.append(x)
        return taps


def nmf_bases(dim: int, rank: int) -> np.ndarray:
    """The fixed NMF start [dim, rank] f32: a uniform sample from
    RandomState(1), each column normalised to unit length."""
    b = np.random.RandomState(1).rand(dim, rank).astype(np.float32)
    return b / np.linalg.norm(b, axis=0, keepdims=True)


def nmf2d(x: torch.Tensor, rank: int, steps: int, eps: float = 1e-6,
          bases: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-`rank` NMF of the non-negative NCHW map x [B, D, H, W] as the
    [B, H*W, D] matrix, by `steps` multiplicative updates (Lee and Seung)
    in f32 from `bases` (default `nmf_bases(D, rank)`); returns the
    reconstruction in x's dtype and layout. The one-step gradient: the
    updates run without a graph, and only the last coefficient update
    (from the detached coefficients and bases) and the reconstruction
    reach x."""
    b_, d, h, w = x.shape
    xf = x.float().reshape(b_, d, h * w).transpose(1, 2)   # [B, N, D]
    if bases is None:
        bases = torch.from_numpy(nmf_bases(d, rank)).to(x.device)
    bases = bases.float().expand(b_, d, rank)

    def coef_update(xin, coef, bases):
        num = torch.bmm(xin, bases)
        den = torch.bmm(coef, torch.bmm(bases.transpose(1, 2), bases))
        return coef * num / (den + eps)

    with torch.no_grad():
        xs = xf.detach()
        coef = torch.softmax(torch.bmm(xs, bases), dim=-1)   # [B, N, R]
        for _ in range(steps):
            coef = coef_update(xs, coef, bases)
            num = torch.bmm(xs.transpose(1, 2), coef)
            den = torch.bmm(bases, torch.bmm(coef.transpose(1, 2), coef))
            bases = bases * num / (den + eps)
    coef = coef_update(xf, coef, bases)
    out = torch.bmm(bases, coef.transpose(1, 2))   # [B, D, N]
    return out.reshape(b_, d, h, w).to(x.dtype)


class _Hamburger(nn.Module):
    """ham_in (1x1, biased) -> ReLU -> nmf2d -> ham_out (1x1) -> GroupNorm;
    ReLU of the input plus that."""

    def __init__(self, channels: int, rank: int, dtype: torch.dtype):
        super().__init__()
        self.rank, self.dtype = rank, dtype
        self.ham_in = raw_conv(channels, channels, 1)
        self.ham_out = nn.Conv2d(channels, channels, 1, bias=False)
        self.ham_out_gn = GroupNorm(32, channels, dtype=dtype)
        self.register_buffer("bases", torch.from_numpy(
            nmf_bases(channels, rank)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        steps = 6 if self.training else 7   # the Ham train / eval steps
        h = F.relu(conv2d(self.ham_in, x, self.dtype))
        h = nmf2d(h, self.rank, steps, bases=self.bases)
        h = self.ham_out_gn(conv2d(self.ham_out, h, self.dtype))
        return F.relu(x + h)


class _GNConv(nn.Module):
    """1x1 conv (no bias) + GroupNorm(32) + ReLU (mmseg ConvModule with a GN
    norm)."""

    def __init__(self, cin: int, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, channels, 1, bias=False)
        self.gn = GroupNorm(32, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(conv2d(self.conv, x, self.dtype)))


class SegNeXt(nn.Module):
    output_stride = 8  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, variant: str = "t",
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True, remat: bool = False,
                 up_align_corners: bool = False,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        _refuse_unported(remat=remat)
        if variant not in MSCAN_VARIANTS:
            raise ValueError(f"unknown SegNeXt variant {variant!r}; "
                             f"available: {sorted(MSCAN_VARIANTS)}")
        depths, dims, ratios, ham_ch, rank = MSCAN_VARIANTS[variant]
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.backbone = MSCAN(depths, dims, ratios, dtype)
        self.squeeze = _GNConv(sum(dims[1:]), ham_ch, dtype)
        self.hamburger = _Hamburger(ham_ch, rank, dtype)
        self.align = _GNConv(ham_ch, ham_ch, dtype)
        self.cls_conv = nn.Conv2d(ham_ch, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] float, H and W multiples of 32 -> f32 logits
        [B, K, H/8, W/8] (or [B, K, H, W] with full_res_output)."""
        in_hw = tuple(x.shape[2:])
        taps = self.backbone(x)
        size = tuple(taps[1].shape[2:])
        y = torch.cat([taps[1]] + [
            resize_bilinear_nchw(t, size, align_corners=False)
            for t in taps[2:]], dim=1)
        y = self.align(self.hamburger(self.squeeze(y)))
        logits = conv2d(self.cls_conv, y, self.dtype).float()
        if self.full_res_output:
            logits = resize_bilinear_nchw(logits, in_hw, align_corners=False)
        return logits
