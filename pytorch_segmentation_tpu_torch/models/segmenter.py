"""Segmenter, a plain ViT and the Mask Transformer decoder (port of
pytorch_segmentation_tpu/models/segmenter.py; Strudel et al., ICCV 2021).

The encoder is `nn/backbones/vit.ViT` (`backbone`, its last block's patch
tokens only, stride 16). The decoder (`decoder`, `_MaskTransformer`):
`proj_dec` (Dense C -> C), the K class embeddings `cls_emb` (1, K, C)
concatenated AFTER the patch tokens, `n_layers` ViT blocks `block{i}` over
the joint sequence, the LayerNorm `decoder_norm` (compute dtype), then
`proj_patch` and `proj_classes` (Dense without bias) on the patch and
class tokens, both cast to f32 and L2-normalized, their product [B, N, K]
in f32 (TF32 stays off on the card: `utils/runtime.require_cuda`), and
`mask_norm`, an f32 LayerNorm over the K classes. The logits are f32 at
stride 16; `full_res_output=True` resizes them to the INPUT size (bilinear,
align_corners=False), else the resize is left to the loss and eval kernels.
`remat` is not ported and raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.vit import VIT_VARIANTS, ViT, _ViTBlock
from ..nn.blocks import LayerNorm, Linear
from ..ops.resize import resize_bilinear_nchw
from .segformer import _refuse_unported

__all__ = ["Segmenter"]


class _MaskTransformer(nn.Module):
    def __init__(self, num_classes: int, dim: int, heads: int,
                 n_layers: int, dtype: torch.dtype):
        super().__init__()
        self.n_layers = n_layers
        self.proj_dec = Linear(dim, dim, dtype)
        self.cls_emb = nn.Parameter(torch.zeros(1, num_classes, dim))
        for i in range(n_layers):
            self.add_module(f"block{i}", _ViTBlock(dim, heads, dtype))
        self.decoder_norm = LayerNorm(dim, dtype)
        self.proj_patch = Linear(dim, dim, dtype, bias=False)
        self.proj_classes = Linear(dim, dim, dtype, bias=False)
        self.mask_norm = LayerNorm(num_classes, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, N, C] patch tokens -> [B, N, K] f32 mask logits."""
        b, n, _ = x.shape
        x = self.proj_dec(x)
        x = torch.cat([x, self.cls_emb.to(x.dtype).expand(b, -1, -1)], dim=1)
        for i in range(self.n_layers):
            x = getattr(self, f"block{i}")(x)
        x = self.decoder_norm(x)
        patches = self.proj_patch(x[:, :n]).float()
        classes = self.proj_classes(x[:, n:]).float()
        patches = patches / torch.linalg.vector_norm(patches, dim=-1,
                                                     keepdim=True)
        classes = classes / torch.linalg.vector_norm(classes, dim=-1,
                                                     keepdim=True)
        return self.mask_norm(torch.matmul(patches, classes.transpose(1, 2)))


class Segmenter(nn.Module):
    output_stride = 16  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, variant: str = "b16",
                 n_decoder_layers: int = 2,
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, remat: bool = False,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        _refuse_unported(remat=remat)
        layers, dim, heads, patch, base_grid, _ = VIT_VARIANTS[variant]
        self.num_classes = num_classes
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.backbone = ViT(layers, dim, heads, patch, base_grid,
                            out_indices=(layers - 1,), dtype=dtype)
        self.decoder = _MaskTransformer(num_classes, dim, heads,
                                        n_decoder_layers, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] float -> f32 logits [B, K, H/16, W/16] (or
        [B, K, H, W] with full_res_output)."""
        in_hw = tuple(x.shape[2:])
        feat = self.backbone(x)[-1]
        b, c, gh, gw = feat.shape
        masks = self.decoder(feat.permute(0, 2, 3, 1).reshape(b, gh * gw, c))
        logits = masks.reshape(b, gh, gw, self.num_classes).permute(0, 3, 1, 2)
        if self.full_res_output:
            logits = resize_bilinear_nchw(logits, in_hw, align_corners=False)
        return logits
