"""DANet (dual attention), NCHW (port of pytorch_segmentation_tpu/models/
danet.py; Fu et al., CVPR 2019, mmseg DAHead conventions).

ResNet-50 (or 101) at output stride 8, then two branches over the 2048
channels of layer 4, each entered through a 3x3 ConvNormAct to `channels`
(512):
  - PAM, position attention (`pam_in`): biased 1x1 query and key
    projections to channels/8 and a value projection to channels
    (`pam_query`, `pam_key`, `pam_value`); the scores q_i . k_j over the N =
    h*w positions in the compute dtype, a softmax over j in f32, the
    attention cast back to the compute dtype and multiplied with v; a
    learned scalar gates the residual (`pam_gamma`: gamma * out + x), then
    a 3x3 ConvNormAct (`pam_out`).
  - CAM, channel attention (`cam_in`): the energy x_i . x_j over the
    positions in the compute dtype, taken to f32, the paper's
    rowmax(energy) - energy, a softmax, the attention cast back and
    multiplied with x; the gate `cam_gamma`, then `cam_out`.
The branches' sum -> 1x1 class conv with bias (`cls_conv`) -> with
`full_res_output=True` a x8 bilinear upsample (align_corners=False).

The [B, N, N] and [B, C, C] products are plain `torch.bmm`, as the JAX
module's einsums run outside any kernel. aux=True adds each branch's class
conv (`pam_cls`, `cam_cls`): a train-mode forward then returns (logits,
(pam logits, cam logits)) at stride 8, never upsampled here; an eval-mode
forward returns the logits alone and does not run them.

`remat=True` recomputes the ResNet's residual blocks and the two
parameter-free attention segments (PAM's scores, softmax and product with
v; CAM's energy, softmax and product) in the backward, as the JAX module's
`jax.checkpoint` of each: the [B, N, N] scores are not kept.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.backbones.resnet import ResNet
from ..nn.blocks import ConvNormAct, Scale, checkpoint, conv2d
from ..ops.resize import resize_bilinear_nchw

__all__ = ["DANet"]


def _pam_attention(q, k, v):
    """q, k [B, ch/8, N] and v [B, ch, N] -> the attended values [B, ch,
    N]."""
    scores = torch.bmm(q.transpose(1, 2), k)        # [B, N, N]
    attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.bmm(v, attn.transpose(1, 2))


def _cam_attention(cf):
    """cf [B, ch, N] -> the channel-attended map [B, ch, N]."""
    energy = torch.bmm(cf, cf.transpose(1, 2)).float()  # [B, ch, ch]
    # the paper's rowmax(energy) - energy, in f32 before the softmax
    energy = energy.amax(dim=-1, keepdim=True) - energy
    attn = torch.softmax(energy, dim=-1).to(cf.dtype)
    return torch.bmm(attn, cf)


class DANet(nn.Module):
    output_stride = 8  # stride of the logits when full_res_output=False

    def __init__(self, num_classes: int, backbone_layers=(3, 4, 6, 3),
                 channels: int = 512, dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, aux: bool = False,
                 remat: bool = False, axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        self.num_classes = num_classes
        self.channels = channels
        self.remat = remat
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.aux = aux
        self.backbone = ResNet("bottleneck", backbone_layers,
                               replace_stride_with_dilation=(False, True,
                                                             True),
                               dtype=dtype, remat=remat)
        ch = channels
        self.pam_in = ConvNormAct(2048, ch, 3, dtype=dtype)
        self.pam_query = nn.Conv2d(ch, ch // 8, 1, bias=True)
        self.pam_key = nn.Conv2d(ch, ch // 8, 1, bias=True)
        self.pam_value = nn.Conv2d(ch, ch, 1, bias=True)
        self.pam_gamma = Scale(1, 0.0)
        self.pam_out = ConvNormAct(ch, ch, 3, dtype=dtype)
        self.cam_in = ConvNormAct(2048, ch, 3, dtype=dtype)
        self.cam_gamma = Scale(1, 0.0)
        self.cam_out = ConvNormAct(ch, ch, 3, dtype=dtype)
        self.cls_conv = nn.Conv2d(ch, num_classes, 1, bias=True)
        if aux:
            self.pam_cls = nn.Conv2d(ch, num_classes, 1, bias=True)
            self.cam_cls = nn.Conv2d(ch, num_classes, 1, bias=True)

    def _pam(self, p: torch.Tensor) -> torch.Tensor:
        b, ch, h, w = p.shape
        dt = self.dtype
        q = conv2d(self.pam_query, p, dt).flatten(2)    # [B, ch/8, N]
        k = conv2d(self.pam_key, p, dt).flatten(2)      # [B, ch/8, N]
        v = conv2d(self.pam_value, p, dt).flatten(2)    # [B, ch, N]
        ctx = (checkpoint(_pam_attention, q, k, v) if self.remat
               else _pam_attention(q, k, v))
        return self.pam_gamma(ctx.view(b, ch, h, w)) + p

    def _cam(self, c: torch.Tensor) -> torch.Tensor:
        b, ch, h, w = c.shape
        cf = c.flatten(2)                                   # [B, ch, N]
        ctx = (checkpoint(_cam_attention, cf) if self.remat
               else _cam_attention(cf))
        return self.cam_gamma(ctx.view(b, ch, h, w)) + c

    def forward(self, x: torch.Tensor):
        """x: [B, 3, H, W] float -> logits [B, C, h, w] in the compute
        dtype at stride 8 (or x8 that with full_res_output); with aux in
        train mode, (logits, (pam logits, cam logits) at stride 8)."""
        y = self.backbone(x)[-1]   # 2048 channels at stride 8 (dilated)
        p = self.pam_out(self._pam(self.pam_in(y)))
        c = self.cam_out(self._cam(self.cam_in(y)))
        out = conv2d(self.cls_conv, p + c, self.dtype)
        if self.full_res_output:
            out = resize_bilinear_nchw(
                out, (8 * out.shape[2], 8 * out.shape[3]),
                align_corners=self.up_align_corners)
        if self.aux and self.training:
            return out, (conv2d(self.pam_cls, p, self.dtype),
                         conv2d(self.cam_cls, c, self.dtype))
        return out
