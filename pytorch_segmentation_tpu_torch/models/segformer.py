"""SegFormer, NCHW maps and (B, N, C) tokens (port of
pytorch_segmentation_tpu/models/segformer.py; Xie et al., NeurIPS 2021).

The Mix Transformer encoder (`_MiT`, named `backbone`): four stages, each an
overlapping patch embedding (`patch_embed{i}_proj`, k7 s4 pad 3 for stage 1
and k3 s2 pad 1 after, then the LayerNorm `patch_embed{i}_ln`), `depth`
blocks `block{i}_{j}` and a closing LayerNorm `norm{i}`; it returns the
stride-4/8/16/32 maps. A block is pre-norm with residuals:
  - `attn` (`ln1` before it), efficient self-attention: the queries `q` on
    every token, the keys and values `kv` on a `sr x sr` strided,
    biased convolution of the map (`sr`, then the LayerNorm `srln`; sr
    ratios 8, 4, 2, 1); k is columns [0:dim] of `kv`, v the rest; the
    scores are the product in the compute dtype, THEN scaled by
    hd**-0.5 rounded to that dtype (the JAX module multiplies the bf16
    scores by a weakly typed Python float); the softmax in f32; the
    attention cast back before the product with v; then `proj`;
  - `ffn` (`ln2` before it), the Mix-FFN: `fc1` (4x), a 3x3 depthwise
    biased convolution `dwconv`, exact GELU (`F.gelu`, one rounding),
    `fc2`.
Tokens come from a map by `flatten(2).transpose(1, 2)`, the JAX module's
row-major `reshape(b, n, c)`; they go back through a channels-last view.

The all-MLP decoder: `linear_c{i}` (Dense to `decoder_dim`) on each stage,
then the fuse (`fuse.conv` (d, 4d, 1, 1) and `fuse.bn`, ReLU) and the 1x1
class conv `cls_conv`. With `split_fuse=True` (the JAX default) the fuse
runs distributively, as the JAX `_SplitFuse` does: kernel slice i feeds
z[-1-i] (the concat order is c4, c3, c2, c1), each slice's product
accumulates in f32 and rounds to the compute dtype at the stage's own
resolution, is resized (align_corners=False) where that differs from
stride 4, and the four are summed in the compute dtype in the order g4 +
g3 + g2 + g1 before the BN. `split_fuse=False` is the literal concat and
`ConvNormAct` on the same parameters. `full_res_output=True` resizes the
stride-4 logits to the INPUT size.

The attention and decoder products are plain `torch.matmul`, as the JAX
module's einsums and `dot_general` run outside any kernel; not
`F.scaled_dot_product_attention`, whose fused softmax rounds elsewhere.

`scan_blocks=True` (the JAX `_BlockStack` layout): a stage deeper than one
block is `blocks{i}`, whose `stack` module is one `_Block` holding each
parameter with a leading layer axis (`backbone.blocks{i}.stack.<leaf>`
[depth, ...]); the block body runs once a layer on that layer's slices
(`torch.func.functional_call`), so the gradient of each layer lands in its
slice of the stack. Stages of depth 1 keep `block{i}_0`.
`stack_block_params` / `unstack_block_params` convert state_dicts between
the two layouts. `remat=True` recomputes each block in the backward
(`nn.blocks.checkpoint`): each `_Block` of an unrolled stage, each layer's
`functional_call` of a stacked one. `pp_mesh` and `moe_experts` (with or
without scan blocks) are not ported and raise.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import ConvNormAct, LayerNorm, Linear, checkpoint, conv2d
from ..ops.resize import resize_bilinear, resize_bilinear_nchw
from ..utils.roadmap import not_ported

__all__ = ["SegFormer", "SEGFORMER_VARIANTS", "stack_block_params",
           "unstack_block_params"]

# embed_dims, depths, num_heads, decoder_dim (the JAX package's table:
# paper Table 6, plus its 'tiny' and 'tiny-d4' test sizes)
SEGFORMER_VARIANTS = {
    "tiny": ((16, 32, 64, 128), (1, 1, 1, 1), (1, 2, 4, 8), 64),
    "tiny-d4": ((16, 32, 64, 128), (1, 1, 4, 1), (1, 2, 4, 8), 64),
    "b0": ((32, 64, 160, 256), (2, 2, 2, 2), (1, 2, 5, 8), 256),
    "b1": ((64, 128, 320, 512), (2, 2, 2, 2), (1, 2, 5, 8), 256),
    "b2": ((64, 128, 320, 512), (3, 4, 6, 3), (1, 2, 5, 8), 768),
    "b3": ((64, 128, 320, 512), (3, 4, 18, 3), (1, 2, 5, 8), 768),
    "b4": ((64, 128, 320, 512), (3, 8, 27, 3), (1, 2, 5, 8), 768),
    "b5": ((64, 128, 320, 512), (3, 6, 40, 3), (1, 2, 5, 8), 768),
}


def _to_map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, N, C) tokens -> the NCHW view [B, C, h, w] (channels-last
    strides)."""
    return t.reshape(t.shape[0], h, w, t.shape[2]).permute(0, 3, 1, 2)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW map -> (B, N, C) tokens, N row-major over (h, w)."""
    return x.flatten(2).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, dtype: torch.dtype):
        super().__init__()
        self.dim, self.heads, self.sr_ratio, self.dtype = dim, heads, sr, dtype
        self.q = Linear(dim, dim, dtype)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, stride=sr, bias=True)
            self.srln = LayerNorm(dim, dtype)
        self.kv = Linear(dim, 2 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)
        hd = dim // heads
        # hd**-0.5 as the compute dtype holds it: the JAX module's Python
        # float meets the bf16 scores as a bf16 scalar
        self.scale = float(torch.tensor(hd ** -0.5, device="cpu").to(dtype))

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        heads, hd = self.heads, self.dim // self.heads
        q = self.q(x).reshape(b, n, heads, hd).transpose(1, 2)
        if self.sr_ratio > 1:
            r = self.srln(_to_tokens(conv2d(self.sr, _to_map(x, h, w),
                                            self.dtype)))
        else:
            r = x
        kv = self.kv(r)
        m = r.shape[1]
        k = kv[..., :self.dim].reshape(b, m, heads, hd).transpose(1, 2)
        v = kv[..., self.dim:].reshape(b, m, heads, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-2, -1)) * self.scale
        attn = torch.softmax(scores.float(), dim=-1)
        y = torch.matmul(attn.to(self.dtype), v)
        return self.proj(y.transpose(1, 2).reshape(b, n, self.dim))


class _MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(dim, hidden, dtype)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden,
                                bias=True)
        self.fc2 = Linear(hidden, dim, dtype)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        y = conv2d(self.dwconv, _to_map(self.fc1(x), h, w), self.dtype)
        return self.fc2(F.gelu(_to_tokens(y), approximate="none"))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, mlp_ratio: int,
                 dtype: torch.dtype):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = _Attention(dim, heads, sr, dtype)
        self.ln2 = LayerNorm(dim, dtype)
        self.ffn = _MixFFN(dim, mlp_ratio * dim, dtype)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), h, w)
        return x + self.ffn(self.ln2(x), h, w)


class _BlockStack(nn.Module):
    """`depth` blocks of one stage as one `_Block` (`stack`) whose every
    parameter carries a leading layer axis; the block body runs once a
    layer on that layer's slices."""

    def __init__(self, dim: int, heads: int, sr: int, mlp_ratio: int,
                 depth: int, dtype: torch.dtype, remat: bool = False):
        super().__init__()
        self.depth, self.remat = depth, remat
        self.stack = _Block(dim, heads, sr, mlp_ratio, dtype)
        for name, p in list(self.stack.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(self.stack.get_submodule(owner), leaf, nn.Parameter(
                p.detach()[None].repeat(depth, *(1,) * p.dim())))

    def _apply(self, fn, recurse=True):
        # `Module.to(memory_format=torch.channels_last)` refuses a 5-D
        # tensor: the stacked conv kernels [depth, O, I, kh, kw] are
        # converted one layer at a time (each slice then has the unrolled
        # block's layout)
        def by_layer(t):
            if t.dim() != 5:
                return fn(t)
            return torch.stack([fn(layer) for layer in t.unbind(0)])
        return super()._apply(by_layer, recurse)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        params = dict(self.stack.named_parameters())

        def layer(x, j):
            return torch.func.functional_call(
                self.stack, {n: p[j] for n, p in params.items()}, (x, h, w))

        for j in range(self.depth):
            x = checkpoint(layer, x, j) if self.remat else layer(x, j)
        return x


class _MiT(nn.Module):
    """Mix Transformer encoder; returns the four stage maps, NCHW."""

    def __init__(self, embed_dims, depths, num_heads, sr_ratios=(8, 4, 2, 1),
                 mlp_ratio: int = 4, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16,
                 scan_blocks: bool = False, remat: bool = False):
        super().__init__()
        self.depths, self.dtype, self.remat = tuple(depths), dtype, remat
        cin = in_channels
        self._stages: list[list[str]] = []
        for i, (dim, depth, heads) in enumerate(zip(embed_dims, depths,
                                                    num_heads)):
            k, s = (7, 4) if i == 0 else (3, 2)
            self.add_module(f"patch_embed{i + 1}_proj", nn.Conv2d(
                cin, dim, k, stride=s, padding=k // 2, bias=True))
            self.add_module(f"patch_embed{i + 1}_ln", LayerNorm(dim, dtype))
            if scan_blocks and depth > 1:
                names = [f"blocks{i + 1}"]
                self.add_module(names[0], _BlockStack(
                    dim, heads, sr_ratios[i], mlp_ratio, depth, dtype,
                    remat))
            else:
                names = [f"block{i + 1}_{j}" for j in range(depth)]
                for name in names:
                    self.add_module(name, _Block(
                        dim, heads, sr_ratios[i], mlp_ratio, dtype))
            self._stages.append(names)
            self.add_module(f"norm{i + 1}", LayerNorm(dim, dtype))
            cin = dim

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i, names in enumerate(self._stages):
            y = conv2d(getattr(self, f"patch_embed{i + 1}_proj"), x,
                       self.dtype)
            h, w = y.shape[2:]
            t = getattr(self, f"patch_embed{i + 1}_ln")(_to_tokens(y))
            for name in names:
                block = getattr(self, name)
                t = (checkpoint(block, t, h, w)
                     if self.remat and isinstance(block, _Block)
                     else block(t, h, w))
            x = _to_map(getattr(self, f"norm{i + 1}")(t), h, w)
            feats.append(x)
        return feats


class _SplitFuse(ConvNormAct):
    """The decoder fuse: `ConvNormAct(4d, d, 1)` whose `split` evaluates it
    distributively over the four stage maps (same parameters)."""

    def split(self, zs, size4) -> torch.Tensor:
        """zs: the four NHWC decoder maps [B, h_i, w_i, d] -> the fused NCHW
        map [B, d, H/4, W/4] after BN and ReLU."""
        d, dt = self.conv.out_channels, self.dtype
        weight = self.conv.weight.to(dt)[:, :, 0, 0]   # (d, 4d)
        acc = None
        for i, z in enumerate(reversed(zs)):
            g = torch.matmul(z.to(dt), weight[:, i * d:(i + 1) * d].t())
            if tuple(g.shape[1:3]) != tuple(size4):
                g = resize_bilinear(g, size4, align_corners=False)
            acc = g if acc is None else acc + g
        return F.relu(self.bn(acc.permute(0, 3, 1, 2)))


class SegFormer(nn.Module):
    output_stride = 4  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, variant: str = "b0",
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, split_fuse: bool = True,
                 remat: bool = False, scan_blocks: bool = False,
                 pp_mesh=None, moe_experts: int = 0,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        if pp_mesh is not None:
            raise not_ported("pp_mesh (pipeline parallelism)", 10)
        if moe_experts > 0:
            raise not_ported("moe_experts > 0 (nn/moe.py)", 10)
        dims, depths, heads, dec_dim = SEGFORMER_VARIANTS[variant]
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.split_fuse = split_fuse
        self.backbone = _MiT(dims, depths, heads, dtype=dtype,
                             scan_blocks=scan_blocks, remat=remat)
        for i, dim in enumerate(dims):
            self.add_module(f"linear_c{i + 1}", Linear(dim, dec_dim, dtype))
        self.fuse = _SplitFuse(4 * dec_dim, dec_dim, 1, dtype=dtype)
        self.cls_conv = nn.Conv2d(dec_dim, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] float, H and W multiples of 32 -> logits
        [B, C, H/4, W/4] in the compute dtype (or [B, C, H, W] with
        full_res_output)."""
        in_hw = tuple(x.shape[2:])
        feats = self.backbone(x)
        size4 = tuple(feats[0].shape[2:])
        zs = [getattr(self, f"linear_c{i + 1}")(f.permute(0, 2, 3, 1))
              for i, f in enumerate(feats)]   # NHWC
        if self.split_fuse:
            y = self.fuse.split(zs, size4)
        else:
            outs = [z if i == 0 else
                    resize_bilinear(z, size4, align_corners=False)
                    for i, z in enumerate(zs)]
            y = self.fuse(torch.cat(outs[::-1], dim=-1).permute(0, 3, 1, 2))
        y = conv2d(self.cls_conv, y, self.dtype)
        if self.full_res_output:
            y = resize_bilinear_nchw(y, in_hw, align_corners=False)
        return y


def _stack(layers):
    if isinstance(layers[0], torch.Tensor):
        return torch.stack(layers)
    return np.stack(layers)


def stack_block_params(sd: dict, variant: str) -> dict:
    """An unrolled SegFormer state_dict (`backbone.block{i}_{j}.<leaf>`,
    tensors or numpy arrays) -> the `scan_blocks` layout
    (`backbone.blocks{i}.stack.<leaf>`, the layers stacked on a leading
    axis). Stages of depth 1 keep their names."""
    depths = SEGFORMER_VARIANTS[variant][1]
    out, stacks = {}, {}
    for name, value in sd.items():
        found = re.fullmatch(r"backbone\.block(\d+)_(\d+)\.(.+)", name)
        if found and depths[int(found[1]) - 1] > 1:
            key = f"backbone.blocks{found[1]}.stack.{found[3]}"
            stacks.setdefault(key, {})[int(found[2])] = value
            out.setdefault(key, None)   # keeps the entries' order
        else:
            out[name] = value
    for key, layers in stacks.items():
        out[key] = _stack([layers[j] for j in range(len(layers))])
    return out


def unstack_block_params(sd: dict, variant: str) -> dict:
    """The inverse of `stack_block_params`."""
    depths = SEGFORMER_VARIANTS[variant][1]
    out = {}
    for name, value in sd.items():
        found = re.fullmatch(r"backbone\.blocks(\d+)\.stack\.(.+)", name)
        if not found:
            out[name] = value
            continue
        for j in range(depths[int(found[1]) - 1]):
            layer = value[j]
            out[f"backbone.block{found[1]}_{j}.{found[2]}"] = (
                layer.clone() if isinstance(layer, torch.Tensor)
                else np.array(layer))
    return out
