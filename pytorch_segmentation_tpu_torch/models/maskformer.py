"""MaskFormer, mask classification over a ResNet, NCHW (port of
pytorch_segmentation_tpu/models/maskformer.py; Cheng et al., NeurIPS 2021),
and its set-prediction criterion `make_maskformer_loss`.

The model:
  - `backbone`: the non-dilated ResNet (`nn/backbones/resnet`), C2..C5;
  - the pixel decoder, FPN's top-down path: `lat0` ... `lat3` (1x1
    ConvNormAct, no activation), each coarser level nearest-resized
    (`ops/resize.resize_nearest`) and added to the next lateral; `pix0`
    (3x3 ConvNormAct) on the stride-4 level and `pixel_proj` (a biased 3x3
    conv, `nn/blocks.conv2d`): the per-pixel embedding [B, D, H/4, W/4];
  - the transformer decoder over the C5 tokens: `input_proj` (a biased 1x1
    conv), DETR's fixed 2-D sine position code on the tokens, the learned
    queries `query_embed` (Q, D) as the queries' position code (the
    queries themselves start at 0), `dec_layers` post-norm layers `dec{i}`
    (self-attention, cross-attention, the ReLU MLP `fc1` / `fc2`, each
    sublayer x + f(x) then a LayerNorm, eps 1e-5);
  - the shared heads: `dec_norm`, `cls_head` (K + 1 logits, the last one
    "no object") and the mask MLP `mask_mlp0..2`, whose embedding meets the
    pixel embedding in one product in the compute dtype, cast to f32.

In train mode (`self.training`) the forward returns the dict {"cls" [B, Q,
K+1], "mask" [B, Q, H/4, W/4]}, both f32, and with `aux_loss` "aux_cls" /
"aux_mask" stacked over the first `dec_layers - 1` layers (the shared
heads on each layer's output). In eval mode it returns the f32 semantic
scores sum_q softmax(cls)[..., :K] * sigmoid(mask) as NCHW [B, K, H/4,
W/4] (channels-last memory), resized x4 (bilinear, `up_align_corners`)
with `full_res_output`.

Attention (`_MHA`): separate `q`, `k`, `v` and `proj` `nn/blocks.Linear`s,
the position codes added to the query and key inputs only, q times
hd**-0.5 in the compute dtype before the product (the JAX module's weakly
typed Python float: the scale rounded to that dtype), the softmax in f32,
cast back for the product with v. Plain `torch.matmul`, never SDPA.

The criterion matches each prediction layer's queries to the classes
present in the labels, on the paper's costs (class probability, sigmoid
focal, dice; weights 1 / 20 / 1), then adds the class cross-entropy over
every query (no-object at `eos_coef`) and the focal and dice losses of the
matched masks, at unit weight per supervised layer. The matchers:
`_sinkhorn_assign` (entropic OT on the card, 50 log-domain iterations, a
dummy column for the unmatched queries, an argmax decode) and
`_hungarian_assign` (scipy's `linear_sum_assignment` on the host: one
device-to-host copy and one host-to-device copy a layer). `remat` is not
ported and raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.backbones.resnet import ResNet
from ..nn.blocks import ConvNormAct, LayerNorm, Linear, conv2d
from ..ops.resize import resize_bilinear_nchw, resize_nearest
from ..parallel.mesh import batch_sum
from ..utils.runtime import host_to_device
from .segformer import _refuse_unported

__all__ = ["MaskFormer", "make_maskformer_loss", "MATCHERS"]

MATCHERS = ("sinkhorn", "hungarian")


def _sine_pos_embed(h: int, w: int, dim: int) -> np.ndarray:
    """DETR's fixed 2-D sine position code, [h*w, dim] f32 (rows over y
    then x; sin and cos of y, then of x; zero-padded to `dim`)."""
    half = dim // 2
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    omega = 1.0 / (10000.0 ** (np.arange(half // 2, dtype=np.float32)
                               / (half // 2)))
    out = []
    for pos in (np.broadcast_to(y, (h, w)), np.broadcast_to(x, (h, w))):
        ang = pos[..., None] * omega
        out.append(np.sin(ang))
        out.append(np.cos(ang))
    pe = np.concatenate(out, -1).reshape(h * w, 2 * (half // 2) * 2)
    if pe.shape[-1] < dim:
        pe = np.pad(pe, ((0, 0), (0, dim - pe.shape[-1])))
    return pe[:, :dim]


@functools.lru_cache(maxsize=32)
def _pos_embed_on(h: int, w: int, dim: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """The position code [1, h*w, dim] in `dtype` on `device`, made once a
    shape: never a host copy per forward."""
    with torch.inference_mode(False):
        return host_to_device(_sine_pos_embed(h, w, dim), device).to(
            dtype)[None]


def _compute_scale(hd: int, dtype: torch.dtype) -> float:
    """hd**-0.5 as the compute dtype holds it."""
    return float(torch.tensor(hd ** -0.5, device="cpu").to(dtype))


class _MHA(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        for name in ("q", "k", "v", "proj"):
            self.add_module(name, Linear(dim, dim, dtype))
        self.scale = _compute_scale(dim // heads, dtype)

    def forward(self, q, k, v, q_pos=None, k_pos=None):
        b, nq, _ = q.shape
        nk = k.shape[1]
        heads, hd = self.heads, self.dim // self.heads
        qi = q if q_pos is None else q + q_pos
        ki = k if k_pos is None else k + k_pos
        qh = self.q(qi).reshape(b, nq, heads, hd).transpose(1, 2)
        kh = self.k(ki).reshape(b, nk, heads, hd).transpose(1, 2)
        vh = self.v(v).reshape(b, nk, heads, hd).transpose(1, 2)
        scores = torch.matmul(qh * self.scale, kh.transpose(-2, -1))
        attn = torch.softmax(scores.float(), dim=-1)
        y = torch.matmul(attn.to(self.dtype), vh)
        return self.proj(y.transpose(1, 2).reshape(b, nq, self.dim))


class _DecoderLayer(nn.Module):
    """DETR's post-norm decoder layer."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.self_attn = _MHA(dim, heads, dtype)
        self.cross_attn = _MHA(dim, heads, dtype)
        self.fc1 = Linear(dim, 4 * dim, dtype)
        self.fc2 = Linear(4 * dim, dim, dtype)
        for name in ("ln1", "ln2", "ln3"):
            self.add_module(name, LayerNorm(dim, dtype, eps=1e-5))

    def forward(self, q, mem, q_pos, m_pos):
        q = self.ln1(q + self.self_attn(q, q, q, q_pos=q_pos, k_pos=q_pos))
        q = self.ln2(q + self.cross_attn(q, mem, mem, q_pos=q_pos,
                                         k_pos=m_pos))
        return self.ln3(q + self.fc2(F.relu(self.fc1(q))))


class MaskFormer(nn.Module):
    output_stride = 4  # stride of the scores when full_res_output=False

    def __init__(self, num_classes: int, backbone_layers=(3, 4, 6, 3),
                 block: str = "bottleneck", num_queries: int = 100,
                 dim: int = 256, mask_dim: int = 256, heads: int = 8,
                 dec_layers: int = 6, fpn_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16,
                 full_res_output: bool = True,
                 up_align_corners: bool = False, remat: bool = False,
                 aux_loss: bool = True,
                 axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name
        _refuse_unported(remat=remat)
        self.num_classes = num_classes
        self.num_queries, self.dim = num_queries, dim
        self.dec_layers = dec_layers
        self.dtype = dtype
        self.full_res_output = full_res_output
        self.up_align_corners = up_align_corners
        self.aux_loss = aux_loss
        self.backbone = ResNet(block, backbone_layers, dtype=dtype)
        expansion = 4 if block == "bottleneck" else 1
        for i, width in enumerate((64, 128, 256, 512)):
            self.add_module(f"lat{i}", ConvNormAct(
                width * expansion, fpn_channels, 1, activate=None,
                dtype=dtype))
        self.pix0 = ConvNormAct(fpn_channels, fpn_channels, 3, dtype=dtype)
        self.pixel_proj = nn.Conv2d(fpn_channels, mask_dim, 3, padding=1,
                                    bias=True)
        self.input_proj = nn.Conv2d(512 * expansion, dim, 1, bias=True)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, dim))
        for i in range(dec_layers):
            self.add_module(f"dec{i}", _DecoderLayer(dim, heads, dtype))
        self.dec_norm = LayerNorm(dim, dtype, eps=1e-5)
        self.cls_head = Linear(dim, num_classes + 1, dtype)
        self.mask_mlp0 = Linear(dim, dim, dtype)
        self.mask_mlp1 = Linear(dim, dim, dtype)
        self.mask_mlp2 = Linear(dim, mask_dim, dtype)

    def _heads(self, qn, pixel_tokens, hw):
        """The shared heads on normalized queries [B, Q, D] -> f32 class
        logits [B, Q, K+1] and mask logits [B, Q, h, w]."""
        e = self.mask_mlp2(F.relu(self.mask_mlp1(F.relu(
            self.mask_mlp0(qn)))))
        masks = torch.matmul(e, pixel_tokens.transpose(1, 2))
        return (self.cls_head(qn).float(),
                masks.reshape(*masks.shape[:2], *hw).float())

    def forward(self, x: torch.Tensor):
        """x: [B, 3, H, W] float, H and W multiples of 32 -> in eval mode
        the f32 scores [B, K, H/4, W/4] (or [B, K, H, W] with
        full_res_output); in train mode the dict of f32 predictions."""
        feats = self.backbone(x)[1:]   # C2..C5
        sizes = [tuple(f.shape[2:]) for f in feats]
        p = self.lat3(feats[3])
        for i in (2, 1, 0):
            up = resize_nearest(p.permute(0, 2, 3, 1), sizes[i])
            p = getattr(self, f"lat{i}")(feats[i]) + up.permute(0, 3, 1, 2)
        pixel_emb = conv2d(self.pixel_proj, self.pix0(p), self.dtype)
        b, _, h4, w4 = pixel_emb.shape
        pixel_tokens = pixel_emb.permute(0, 2, 3, 1).reshape(b, h4 * w4, -1)

        c5 = conv2d(self.input_proj, feats[3], self.dtype)
        h5, w5 = c5.shape[2:]
        mem = c5.flatten(2).transpose(1, 2)     # [B, h5*w5, D], row-major
        m_pos = _pos_embed_on(h5, w5, self.dim, self.dtype, mem.device)
        q_pos = self.query_embed.to(self.dtype)[None]
        q = torch.zeros(b, self.num_queries, self.dim, dtype=self.dtype,
                        device=mem.device)
        aux = []
        for i in range(self.dec_layers):
            q = getattr(self, f"dec{i}")(q, mem, q_pos, m_pos)
            if (self.training and self.aux_loss
                    and i < self.dec_layers - 1):
                aux.append(self._heads(self.dec_norm(q), pixel_tokens,
                                       (h4, w4)))
        cls_logits, mask_logits = self._heads(self.dec_norm(q), pixel_tokens,
                                              (h4, w4))
        if self.training:
            out = {"cls": cls_logits, "mask": mask_logits}
            if aux:
                out["aux_cls"] = torch.stack([a[0] for a in aux])
                out["aux_mask"] = torch.stack([a[1] for a in aux])
            return out

        p_cls = torch.softmax(cls_logits, -1)[..., :self.num_classes]
        m = torch.sigmoid(mask_logits).flatten(2)      # [B, Q, h*w]
        sem = torch.matmul(m.transpose(1, 2), p_cls)    # [B, h*w, K]
        sem = sem.reshape(b, h4, w4, self.num_classes).permute(0, 3, 1, 2)
        if self.full_res_output:
            sem = resize_bilinear_nchw(sem, (4 * h4, 4 * w4),
                                       align_corners=self.up_align_corners)
        return sem


# ---------------------------------------------------------------------------
# the set-prediction criterion
# ---------------------------------------------------------------------------

@torch.no_grad()
def _sinkhorn_assign(cost: torch.Tensor, present: torch.Tensor,
                     iters: int = 50, eps: float = 0.05) -> torch.Tensor:
    """Entropic OT on [B, Q, C] f32 costs: absent classes cost `big`, a
    dummy column of zero cost takes the Q - n_present unmatched queries'
    mass; 50 log-domain updates of the column, then the row potentials;
    each present class takes the query of its largest plan entry (the
    first on a tie). Returns the one-hot assignment [B, C, Q] f32."""
    b, nq, nc = cost.shape
    big = 1e4
    cost = cost.float().masked_fill(~present[:, None, :], big)
    cost_a = torch.cat([cost, cost.new_zeros(b, nq, 1)], -1)
    present_f = present.float()
    npres = present_f.sum(-1, keepdim=True)
    col_mass = torch.cat([present_f, nq - npres], -1)       # [B, C+1]
    logk = -cost_a / eps
    lc = torch.log(col_mass.clamp(min=1e-9))
    u = cost.new_zeros(b, nq)
    v = torch.zeros_like(lc)
    for _ in range(iters):
        v = lc - torch.logsumexp(logk + u[..., None], dim=1)
        u = -torch.logsumexp(logk + v[:, None, :], dim=2)
    logp = logk + u[..., None] + v[:, None, :]
    qstar = torch.argmax(logp[..., :nc], dim=1)             # [B, C]
    asgn = (qstar[..., None] == torch.arange(nq, device=cost.device)).float()
    return asgn * present_f[..., None]


@torch.no_grad()
def _hungarian_assign(cost: torch.Tensor,
                      present: torch.Tensor) -> torch.Tensor:
    """The exact assignment of scipy's `linear_sum_assignment` on each
    sample's present columns: the cost and the presence go to the host in
    one copy, the [B, C, Q] one-hot comes back through pinned memory."""
    from scipy.optimize import linear_sum_assignment
    b, nq, nc = cost.shape
    host = torch.cat([cost.float(), present[:, None, :].float()],
                     1).cpu().numpy()
    out = np.zeros((b, nc, nq), np.float32)
    for i in range(b):
        cols = np.nonzero(host[i, nq] > 0)[0]
        if len(cols) == 0:
            continue
        r, c = linear_sum_assignment(host[i, :nq][:, cols])
        out[i, cols[c], r] = 1.0
    return host_to_device(out, cost.device)


def _targets(segs: torch.Tensor, hw, num_classes: int):
    """The criterion's targets at the mask logits' size `hw`: the labels'
    stride-aligned order-0 subsample as a one-hot [B, h*w, K] (a zero row
    for a label >= K, such as 255), the valid pixels [B, h*w] (label < K),
    their count [B] (at least 1), each class's pixel count [B, K] and its
    presence [B, K]."""
    hh, ww = hw
    b = segs.shape[0]
    sy, sx = segs.shape[1] // hh, segs.shape[2] // ww
    tgt = segs[:, ::sy, ::sx][:, :hh, :ww].reshape(b, hh * ww)
    classes = torch.arange(num_classes, device=segs.device)
    onehot = (tgt[..., None] == classes).float()
    valid = (tgt < num_classes).float()
    tsum = onehot.sum(1)
    return onehot, valid, valid.sum(1).clamp(min=1.0), tsum, tsum > 0


def _layer_costs(cls, mask, targets, num_classes: int, w_cls: float = 1.0,
                 w_focal: float = 20.0, w_dice: float = 1.0,
                 focal_alpha: float = 0.25, focal_gamma: float = 2.0):
    """One prediction layer's terms: the class log-probabilities [B, Q,
    K+1], the sigmoid focal [B, Q, K] and dice [B, Q, K] loss of each query
    against each class's target mask (ignored pixels in no sum), and the
    matching cost [B, Q, K] that weighs the three."""
    onehot, valid, nvalid, tsum, _ = targets
    logp = F.log_softmax(cls, -1)
    m = torch.sigmoid(mask).flatten(2)                      # [B, Q, hw]
    vmask = valid[:, None]
    fpos = (-focal_alpha * (1 - m) ** focal_gamma
            * torch.log(m.clamp(min=1e-8)))
    fneg = (-(1 - focal_alpha) * m ** focal_gamma
            * torch.log((1 - m).clamp(min=1e-8)) * vmask)
    inter = torch.matmul(m * vmask, onehot)                 # [B, Q, K]
    pos = torch.matmul(fpos, onehot)
    neg = fneg.sum(2)[..., None] - torch.matmul(fneg, onehot)
    focal_qc = (pos + neg) / nvalid[:, None, None]
    dice_qc = 1.0 - (2 * inter + 1.0) / (
        (m * vmask).sum(2)[..., None] + tsum[:, None, :] + 1.0)
    cost = (w_cls * -torch.exp(logp[..., :num_classes])
            + w_focal * focal_qc + w_dice * dice_qc)
    return logp, focal_qc, dice_qc, cost


def make_maskformer_loss(num_classes: int, matcher: str = "sinkhorn",
                         w_cls: float = 1.0, w_focal: float = 20.0,
                         w_dice: float = 1.0, eos_coef: float = 0.1,
                         focal_alpha: float = 0.25,
                         focal_gamma: float = 2.0):
    """`loss_fn(outputs, segs)` for `make_train_step`: outputs is the
    train-mode dict, segs [B, H, W] integer labels at a multiple of the
    mask logits' size (`_targets`: a label >= num_classes, such as 255, is
    in no target and in no pixel sum). Each image is matched on its own;
    the class and mask terms are ratios of batch sums, which a mesh takes
    over every rank."""
    if matcher not in MATCHERS:
        raise ValueError(f"matcher must be one of {MATCHERS}, not "
                         f"{matcher!r}")
    match = _hungarian_assign if matcher == "hungarian" else _sinkhorn_assign

    def one_layer(cls, mask, targets):
        """The matched loss of one prediction layer (each layer is matched
        on its own)."""
        logp, focal_qc, dice_qc, cost = _layer_costs(
            cls, mask, targets, num_classes, w_cls, w_focal, w_dice,
            focal_alpha, focal_gamma)
        asgn = match(cost.detach(), targets[4])              # [B, K, Q]
        q_cls_logp = torch.einsum("bcq,bqc->bq", asgn,
                                  logp[..., :num_classes])
        # clamped: a Sinkhorn decode collision must not flip the sign of
        # the no-object term
        matched = asgn.sum(1).clamp(max=1.0)                 # [B, Q]
        ce = -(q_cls_logp + (1 - matched) * eos_coef
               * logp[..., num_classes])
        focal_m = torch.einsum("bcq,bqc->bc", asgn, focal_qc)
        dice_m = torch.einsum("bcq,bqc->bc", asgn, dice_qc)
        # ratios of batch sums: each sum over a mesh's ranks
        ce_sum, denom, mask_sum, n_match = batch_sum(
            ce.sum(), matched.sum() + eos_coef * (1 - matched).sum(),
            w_focal * focal_m.sum() + w_dice * dice_m.sum(), asgn.sum())
        loss_cls = ce_sum / denom.clamp(min=1.0)
        loss_mask = mask_sum / n_match.clamp(min=1.0)
        return w_cls * loss_cls + loss_mask

    def loss_fn(outputs, segs):
        targets = _targets(segs, outputs["mask"].shape[2:], num_classes)
        total = one_layer(outputs["cls"], outputs["mask"], targets)
        if "aux_cls" in outputs:
            for cls, mask in zip(outputs["aux_cls"], outputs["aux_mask"]):
                total = total + one_layer(cls, mask, targets)
        return total

    return loss_fn
