"""Swin Transformer trunk (port of pytorch_segmentation_tpu/nn/backbones/
swin.py; Liu et al., ICCV 2021), torchvision's semantics under the JAX
package's names:
  - `patch_conv` (4x4, stride 4, with bias), then the LayerNorm
    `patch_norm`;
  - four stages of `stage{s}_block{b}`, joined by `merge{s}`
    (`_PatchMerging`: the 2x2 neighbours concatenated in the order
    [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2], odd sizes padded
    first, the LayerNorm `norm` over 4C, then `reduction` to 2C without
    bias);
  - a block: `norm1`, the (shifted-)window attention `attn`, the residual;
    `norm2`, `fc1` (4C), exact GELU, `fc2`, the residual. The blocks of odd
    index shift by window // 2.
Every LayerNorm has eps 1e-5 (torch's default).

The window attention of an NHWC map [b, h, w, c]: the map is padded with
zeros at the bottom and right to multiples of the window; the shift of an
axis is 0 where the window covers the whole padded axis; the map is rolled
by minus the shift, cut into windows, `qkv` (one Dense to 3C), q scaled by
hd**-0.5 rounded to the compute dtype BEFORE the product with k, the
relative-position bias (`rpb`, a ((2ws-1)^2, heads) table gathered through
`_rel_pos_index`) and, where a shift is on, the -100 mask of the nine
shifted regions built over the PADDED canvas (`_shift_mask`) added in the
compute dtype, the softmax in f32, the product with v in the compute dtype,
the windows joined, rolled back, cropped to h x w, `proj`. The index and the
mask are per-shape constants, copied to the device once per (shape, device).
The products are plain `torch.matmul`, never SDPA, whose fused softmax
rounds elsewhere.

The trunk runs on NHWC tensors, as the JAX module does, and returns the four
stage outputs at strides 4/8/16/32, C..8C wide, as NCHW views. Drop-path is
omitted, as in the JAX module. `remat=True` recomputes each block in the
backward (`nn.blocks.checkpoint`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..blocks import LayerNorm, Linear, checkpoint, nhwc_conv

__all__ = ["SwinTransformer", "SWIN_VARIANTS"]

# depths, embed dim C, heads, window (the JAX package's table: torchvision
# swin_t / s / b, and its 'pico' test size with window 4)
SWIN_VARIANTS = {
    "pico": ((1, 2, 2, 1), 16, (1, 2, 4, 8), 4),
    "t": ((2, 2, 6, 2), 96, (3, 6, 12, 24), 7),
    "s": ((2, 2, 18, 2), 96, (3, 6, 12, 24), 7),
    "b": ((2, 2, 18, 2), 128, (4, 8, 16, 32), 7),
}
LN_EPS = 1e-5


def _rel_pos_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] lookup into the (2ws-1)^2 bias table (the Swin and
    torchvision formula)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_mask(ph: int, pw: int, ws: int, sh: int, sw: int) -> np.ndarray:
    """[num_windows, ws*ws, ws*ws] additive mask (0 / -100) separating the
    nine shifted regions, built over the padded canvas as torchvision does."""
    canvas = np.zeros((ph, pw), np.int32)
    cnt = 0
    for h0, h1 in ((0, ph - ws), (ph - ws, ph - sh), (ph - sh, ph)):
        for w0, w1 in ((0, pw - ws), (pw - ws, pw - sw), (pw - sw, pw)):
            canvas[h0:h1, w0:w1] = cnt
            cnt += 1
    ids = canvas.reshape(ph // ws, ws, pw // ws, ws).transpose(0, 2, 1, 3)
    ids = ids.reshape(-1, ws * ws)
    return np.where(ids[:, :, None] == ids[:, None, :],
                    0.0, -100.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_rel_pos_index(ws: int, device) -> torch.Tensor:
    """`_rel_pos_index(ws)` flattened, int64 on `device`, copied there once
    and shared; made outside inference mode (like ops/resize's matrices)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_rel_pos_index(ws).reshape(-1)).to(device)


@functools.lru_cache(maxsize=64)
def _device_shift_mask(ph: int, pw: int, ws: int, sh: int, sw: int,
                       dtype, device) -> torch.Tensor:
    """`_shift_mask` in `dtype` on `device`, as [num_windows, 1, n, n]
    (broadcast over the heads), copied there once and shared."""
    with torch.inference_mode(False):
        return torch.from_numpy(_shift_mask(ph, pw, ws, sh, sw)).to(
            device=device, dtype=dtype)[:, None]


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.window, self.shift = window, shift
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.rpb = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.proj = Linear(dim, dim, dtype)
        # hd**-0.5 as the compute dtype holds it: the JAX module's Python
        # float meets the bf16 q as a bf16 scalar
        self.scale = float(torch.tensor((dim // heads) ** -0.5,
                                        device="cpu").to(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NHWC
        b, h, w, c = x.shape
        ws, heads, dt = self.window, self.heads, self.dtype
        pad_b, pad_r = (-h) % ws, (-w) % ws
        ph, pw = h + pad_b, w + pad_r
        sh = self.shift if ws < ph else 0
        sw = self.shift if ws < pw else 0
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        if sh or sw:
            x = torch.roll(x, (-sh, -sw), dims=(1, 2))
        nh, nw, n, hd = ph // ws, pw // ws, ws * ws, self.dim // heads
        xw = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        qkv = self.qkv(xw.reshape(b, nh * nw, n, c))
        qkv = qkv.reshape(b, nh * nw, n, 3, heads, hd).permute(3, 0, 1, 4, 2,
                                                               5)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        scores = torch.matmul(q, k.transpose(-2, -1))   # [b, nW, heads, n, n]
        bias = self.rpb[_device_rel_pos_index(ws, x.device)]
        scores = scores + bias.reshape(n, n, heads).permute(2, 0, 1).to(
            scores.dtype)
        if sh or sw:
            scores = scores + _device_shift_mask(ph, pw, ws, sh, sw,
                                                 scores.dtype, x.device)
        attn = torch.softmax(scores.float(), dim=-1)
        y = torch.matmul(attn.to(dt), v)             # [b, nW, heads, n, hd]
        y = y.permute(0, 1, 3, 2, 4).reshape(b, nh, nw, ws, ws, self.dim)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, self.dim)
        if sh or sw:
            y = torch.roll(y, (sh, sw), dims=(1, 2))
        return self.proj(y[:, :h, :w])


class _SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype, eps=LN_EPS)
        self.attn = _WindowAttention(dim, heads, window, shift, dtype)
        self.norm2 = LayerNorm(dim, dtype, eps=LN_EPS)
        self.fc1 = Linear(dim, 4 * dim, dtype)
        self.fc2 = Linear(4 * dim, dim, dtype)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.attn(self.norm1(x))

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)),
                                   approximate="none"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.attention(x))


class _PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype, eps=LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, dtype, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NHWC
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Returns the four stage maps (NCHW) at strides 4/8/16/32, C..8C
    wide."""

    def __init__(self, depths=(2, 2, 6, 2), dim: int = 96,
                 heads=(3, 6, 12, 24), window: int = 7, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.depths, self.dtype, self.remat = tuple(depths), dtype, remat
        self.patch_conv = nn.Conv2d(in_channels, dim, 4, stride=4, bias=True)
        self.patch_norm = LayerNorm(dim, dtype, eps=LN_EPS)
        for s, depth in enumerate(depths):
            width = dim * 2 ** s
            if s > 0:
                self.add_module(f"merge{s}", _PatchMerging(width // 2, dtype))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", _SwinBlock(
                    width, heads[s], window, 0 if b % 2 == 0 else window // 2,
                    dtype))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.patch_norm(nhwc_conv(self.patch_conv, x.permute(0, 2, 3, 1),
                                      self.dtype))
        taps = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"merge{s}")(x)
            for b in range(depth):
                block = getattr(self, f"stage{s}_block{b}")
                x = checkpoint(block, x) if self.remat else block(x)
            taps.append(x.permute(0, 3, 1, 2))
        return taps
