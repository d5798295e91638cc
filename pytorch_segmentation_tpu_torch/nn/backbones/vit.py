"""Plain Vision Transformer trunk (port of pytorch_segmentation_tpu/nn/
backbones/vit.py; Dosovitskiy et al., ICLR 2021), torchvision's semantics
under the JAX package's names:
  - `conv_proj`: a patch x patch conv of stride patch, with bias;
  - the class token `class_token` (1, 1, C) put FIRST, then the position
    embedding `pos_embedding` (1, 1 + g^2, C) added to the whole sequence
    in the compute dtype. Its g x g grid (g = `base_grid`, 14 for 224-pixel
    weights) is resized bicubically (`ops/resize.resize_bicubic`, align
    False, in f32 on the f32 parameter) to the input's patch grid where the
    two differ, inside the forward, so its gradient flows through the resize;
  - `block{i}` (`_ViTBlock`): `ln1`, the fused `qkv` Dense, q scaled by
    hd**-0.5 rounded to the compute dtype BEFORE the product with k, the
    softmax in f32, the product with v in the compute dtype, `proj`, the
    residual; `ln2`, `fc1` (4C), exact GELU, `fc2`, the residual. LayerNorm
    eps 1e-6. The products are plain `torch.matmul`, never SDPA.
No final LayerNorm on the taps. The trunk returns the sequences after the
`out_indices` blocks, class token dropped, as stride-`patch` NCHW maps
(views of the (B, 1 + N, C) tokens). `remat=True` recomputes each block in
the backward (`nn.blocks.checkpoint`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bicubic
from ..blocks import LayerNorm, Linear, checkpoint, conv2d

__all__ = ["ViT", "VIT_VARIANTS"]

# layers, dim, heads, patch, base grid, out_indices (the JAX package's
# table: torchvision vit_b_16 / vit_l_16 with mmseg's upernet_vit taps, and
# its 'pico' test size)
VIT_VARIANTS = {
    "pico": (4, 32, 2, 16, 4, (0, 1, 2, 3)),
    "b16": (12, 768, 12, 16, 14, (2, 5, 8, 11)),
    "l16": (24, 1024, 16, 16, 14, (5, 11, 17, 23)),
}


class _ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.ln1 = LayerNorm(dim, dtype)
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)
        self.ln2 = LayerNorm(dim, dtype)
        self.fc1 = Linear(dim, 4 * dim, dtype)
        self.fc2 = Linear(4 * dim, dim, dtype)
        # hd**-0.5 as the compute dtype holds it: the JAX module's Python
        # float meets the bf16 q as a bf16 scalar
        self.scale = float(torch.tensor((dim // heads) ** -0.5,
                                        device="cpu").to(dtype))

    def attention(self, x: torch.Tensor) -> torch.Tensor:   # [B, T, C]
        b, t, _ = x.shape
        heads = self.heads
        qkv = self.qkv(self.ln1(x)).reshape(b, t, 3, heads,
                                            self.dim // heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)                  # [3, b, h, t, hd]
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1)).float(),
                             dim=-1)
        y = torch.matmul(attn.to(self.dtype), v)
        return x + self.proj(y.transpose(1, 2).reshape(b, t, self.dim))

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="none"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.attention(x))


class ViT(nn.Module):
    """Returns one stride-`patch` NCHW map per `out_indices` block."""

    def __init__(self, layers: int = 12, dim: int = 768, heads: int = 12,
                 patch: int = 16, base_grid: int = 14,
                 out_indices=(2, 5, 8, 11), in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers, self.dim, self.base_grid = layers, dim, base_grid
        self.out_indices, self.dtype = tuple(out_indices), dtype
        self.conv_proj = nn.Conv2d(in_channels, dim, patch, stride=patch,
                                   bias=True)
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1 + base_grid ** 2,
                                                      dim))
        for i in range(layers):
            self.add_module(f"block{i}", _ViTBlock(dim, heads, dtype))

    def position_embedding(self, gh: int, gw: int) -> torch.Tensor:
        """The (1, 1 + gh*gw, C) f32 position embedding of a gh x gw patch
        grid: the stored grid, resized bicubically where it differs."""
        g, c = self.base_grid, self.dim
        pos = self.pos_embedding
        if (gh, gw) == (g, g):
            return pos
        grid = resize_bicubic(pos[:, 1:].reshape(1, g, g, c), (gh, gw),
                              align_corners=False)
        return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, c)], dim=1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        y = conv2d(self.conv_proj, x, self.dtype)
        b, c, gh, gw = y.shape
        seq = torch.cat([self.class_token.to(self.dtype).expand(b, 1, c),
                         y.flatten(2).transpose(1, 2)], dim=1)
        seq = seq + self.position_embedding(gh, gw).to(self.dtype)
        taps = []
        for i in range(self.layers):
            block = getattr(self, f"block{i}")
            seq = checkpoint(block, seq) if self.remat else block(seq)
            if i in self.out_indices:
                taps.append(seq[:, 1:].reshape(b, gh, gw, c).permute(
                    0, 3, 1, 2))
        return taps
