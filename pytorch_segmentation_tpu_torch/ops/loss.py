"""Segmentation losses (port of pytorch_segmentation_tpu/ops/loss.py).

`compute_loss` bilinearly upsamples the logits to the label resolution
(align_corners=True by default) and takes the mean softmax cross-entropy over
all pixels, in f32. `make_loss_fn` is the train step's loss: where the logits
are below the label resolution it goes through the fused upsample+CE kernel
(ops/kernels/softmax_ce.py), which never writes full-resolution logits.

`build_loss` names the train CLI's losses (`LOSSES`, `train --loss`):
`weighted_cross_entropy` (class weights, label smoothing, OHEM,
`ignore_index`), `lovasz_softmax_loss`, `focal_bce_loss`, `dice_loss` and the
rectangularity prior of ops/rect_loss.py. They run in plain PyTorch on
full-resolution f32 logits, as the JAX package runs them outside any Pallas
kernel; only `build_loss("ce")` with no knob keeps the fused kernel (it is
`compute_loss` itself, which the Trainer recognises).

Under a mesh (`parallel.mesh.batch_statistics_over`, the train step over
several ranks) a loss that is a ratio of batch sums (CE with `ignore_index`,
class weights or smoothing; Dice) takes both sums over every rank, so each
rank's value is the global batch's; a mean over equal per-rank shards (the
plain CE, focal, rect, distillation) is the global one once the step
averages over ranks. OHEM's k-th value and Lovász's sorts need the whole
global batch at once and raise when it spans several ranks.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import batch_sum, require_local_batch
from ..utils.runtime import device_constant
from .kernels.softmax_ce import fused_upsample_ce
from .resize import resize_bilinear

__all__ = ["softmax_cross_entropy", "weighted_cross_entropy", "compute_loss",
           "make_loss_fn", "focal_bce_loss", "lovasz_softmax_loss",
           "dice_loss", "build_loss", "LOSSES"]


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0, which is +1 (torch's abs has 0)."""
    return torch.where(x >= 0, x, -x)


def _true_logit(logits: torch.Tensor, labels: torch.Tensor,
                ignore_index: int | None):
    """(labels clipped into [0, C) with ignored pixels at 0, the valid mask
    or None, each pixel's logit of its label)."""
    safe_labels = labels.long()
    valid = None
    if ignore_index is not None:
        valid = labels != ignore_index
        safe_labels = torch.where(valid, safe_labels,
                                  torch.zeros_like(safe_labels))
    safe_labels = safe_labels.clamp(0, logits.shape[-1] - 1)
    true_logit = logits.gather(-1, safe_labels.unsqueeze(-1)).squeeze(-1)
    return safe_labels, valid, true_logit


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int | None = None) -> torch.Tensor:
    """Mean CE over pixels. logits [..., C] any float, labels [...] int.
    Labels are clipped into [0, C) for the gather, as in the JAX package."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    _, valid, true_logit = _true_logit(logits, labels, ignore_index)
    per_pixel = lse - true_logit
    if ignore_index is not None:
        validf = valid.float()
        total, count = batch_sum((per_pixel * validf).sum(), validf.sum())
        return total / count.clamp(min=1.0)
    return per_pixel.mean()


def compute_loss(logits: torch.Tensor, targets: torch.Tensor,
                 ignore_index: int | None = None,
                 align_corners: bool = True) -> torch.Tensor:
    """logits [B, h, w, C] at the model's output resolution, targets
    [B, H, W] integer class ids: upsample the logits to (H, W) in f32, then
    the mean CE."""
    logits = resize_bilinear(logits.float(), targets.shape[1:3],
                             align_corners=align_corners)
    return softmax_cross_entropy(logits, targets, ignore_index=ignore_index)


def make_loss_fn(align_corners: bool = True, use_pallas: bool = True):
    """Loss for the train step. With `use_pallas` (the JAX package's name
    for "use the fused kernel"), logits below the label resolution go through
    `fused_upsample_ce`: the hand-written CUDA kernels on the card, their
    plain version on the CPU. Logits already at the label resolution, and
    `use_pallas=False`, take `compute_loss`."""
    def loss_fn(logits, targets):
        low_res = tuple(logits.shape[1:3]) != tuple(targets.shape[1:3])
        if use_pallas and low_res:
            return fused_upsample_ce(logits, targets,
                                     align_corners=align_corners)
        return compute_loss(logits, targets, align_corners=align_corners)
    return loss_fn


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                           class_weights=None, label_smoothing: float = 0.0,
                           ohem_frac: float = 0.0, ohem_thresh: float = 0.7,
                           ignore_index: int | None = None) -> torch.Tensor:
    """Softmax CE with three composable knobs, as the JAX function:

      class_weights [C]   torch CrossEntropyLoss(weight=) semantics:
                          sum_i w[y_i] * ce_i / sum_i w[y_i]
      label_smoothing eps torch label_smoothing semantics, weighted
                          composition included: the NLL term weighted by
                          w[y_i], the smooth term by w[c] inside the class
                          sum, BOTH normalized by sum_i w[y_i]:
                            (1-eps) * sum_i w[y_i]*(lse_i - z_iy) / W
                          + (eps/C) * sum_i sum_c w[c]*(lse_i - z_ic) / W
      ohem_frac f > 0     online hard example mining (mmseg's
                          OhemPixelSampler): keep the pixels whose
                          true-class probability is at most
                          max(ohem_thresh, the k-th smallest of them),
                          k = max(1, int(f * N)); the mean is over the kept
                          pixels only. Ignored pixels are never kept.

    logits [..., C] (any float), labels [...] int. All math in f32."""
    if ohem_frac:
        require_local_batch("OHEM")
    logits = logits.float()
    num_classes = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    safe_labels, valid, true_logit = _true_logit(logits, labels,
                                                 ignore_index)
    nll = lse - true_logit
    cw = None
    wy = torch.ones_like(nll)
    if class_weights is not None:
        if isinstance(class_weights, torch.Tensor):
            cw = class_weights.to(logits.device, torch.float32)
        else:   # copied to the card once, not at every step
            cw = device_constant(tuple(float(v) for v in class_weights),
                                 logits.device)
        wy = cw[safe_labels]
    mask = (torch.ones_like(nll) if valid is None else valid.float())
    if ohem_frac:
        with torch.no_grad():
            # hardness = true-class probability; ignored pixels at +inf
            p_true = torch.exp(true_logit - lse)
            if valid is not None:
                p_true = torch.where(valid, p_true,
                                     torch.full_like(p_true, float("inf")))
            flat_p = p_true.reshape(-1)
            k = max(1, int(float(ohem_frac) * flat_p.shape[0]))
            # the k-th smallest p_true is the floor of the kept set (the
            # JAX package's top_k(-p, k)[-1], without sorting every pixel)
            kth = torch.kthvalue(flat_p, k).values
            cutoff = torch.clamp(kth, min=float(ohem_thresh))
            mask = mask * (p_true <= cutoff).float()
    sums = [(nll * wy * mask).sum(), (wy * mask).sum()]
    if label_smoothing:
        if cw is None:
            # sum_c (lse - z_c) = C * lse - sum_c z_c
            smooth = num_classes * lse - logits.sum(dim=-1)
        else:
            smooth = cw.sum() * lse - torch.tensordot(logits, cw,
                                                      dims=([-1], [0]))
        sums.append((smooth * mask).sum())
    sums = batch_sum(*sums)
    denom = sums[1].clamp(min=1e-12)
    loss = sums[0] / denom
    if label_smoothing:
        eps = float(label_smoothing)
        loss = (1.0 - eps) * loss + (eps / num_classes) * sums[2] / denom
    return loss


LOSSES = ("ce", "lovasz", "ce+lovasz", "focal", "ce+rect", "dice",
          "ce+dice")


def build_loss(name: str, align_corners: bool = True, class_weights=None,
               label_smoothing: float = 0.0, ohem_frac: float = 0.0,
               ohem_thresh: float = 0.7, ignore_index: int | None = None):
    """The train CLI's named losses (`train --loss`), as the JAX function.

    'ce' with no knob returns `compute_loss` itself, so that the Trainer's
    deferred upsample and the fused upsample+CE kernel still apply. Every
    other choice returns a `loss_fn(logits, targets)` for which the Trainer
    keeps the model's own upsample, so the logits arrive at the label
    resolution (they are resized here, with `align_corners`, where not):

      lovasz     Lovász-softmax
      ce+lovasz  CE + Lovász
      focal      focal BCE on one-hot targets
      ce+rect    CE + the rectangularity prior (ops/rect_loss.py)
      dice       soft multi-class Dice
      ce+dice    CE + Dice

    class_weights / label_smoothing / ohem_frac (+ ohem_thresh) /
    ignore_index modify the CE term (`weighted_cross_entropy`); setting one
    on a loss without a CE term raises a ValueError."""
    knobs = (class_weights is not None or label_smoothing or ohem_frac
             or ignore_index is not None)
    if knobs and name not in ("ce", "ce+lovasz", "ce+rect", "ce+dice"):
        raise ValueError(
            f"--class-weights/--label-smoothing/--ohem/--ignore-index "
            f"modify the CE term, but loss {name!r} has none")
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r} (choose from {LOSSES})")
    if name == "ce" and not knobs:
        return compute_loss

    def up(logits, targets):
        if tuple(logits.shape[1:3]) != tuple(targets.shape[1:3]):
            logits = resize_bilinear(logits.float(), targets.shape[1:3],
                                     align_corners=align_corners)
        return logits.float()

    def ce(logits, targets):
        return weighted_cross_entropy(
            logits, targets, class_weights=class_weights,
            label_smoothing=label_smoothing, ohem_frac=ohem_frac,
            ohem_thresh=ohem_thresh, ignore_index=ignore_index)

    def focal(logits, targets):
        classes = torch.arange(logits.shape[-1], device=targets.device)
        return focal_bce_loss(logits, targets.unsqueeze(-1) == classes)

    def rect(logits, targets):
        from .rect_loss import rect_loss
        return rect_loss(logits)

    terms = {"ce": (ce,), "lovasz": (lovasz_softmax_loss,),
             "ce+lovasz": (ce, lovasz_softmax_loss), "focal": (focal,),
             "ce+rect": (ce, rect), "dice": (dice_loss,),
             "ce+dice": (ce, dice_loss)}[name]

    def loss_fn(logits, targets):
        logits = up(logits, targets)
        loss = terms[0](logits, targets)
        for term in terms[1:]:
            loss = loss + term(logits, targets)
        return loss
    return loss_fn


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Soft multi-class Dice loss: 1 - mean over the classes present in the
    batch of (2|P∩G| + smooth) / (|P| + |G| + smooth) on softmax
    probabilities. logits [..., C], targets [...] int.

    |P∩G| is a per-class sum of the true-class probabilities and |G| a
    count, both by `index_add`: no [N, C] one-hot. A label of C or above
    (an ignored pixel) counts in no class, as in the JAX package (whose
    segment sums drop it); negative labels are not held to it. On the card
    `index_add` adds with atomics, so the f32 sums of |P∩G| vary in their
    last bits from run to run (the counts are integers below 2^24, exact in
    any order); the gradient (a gather) does not."""
    num_classes = logits.shape[-1]
    probas = torch.softmax(logits.float(), dim=-1).reshape(-1, num_classes)
    t = targets.reshape(-1).long()
    counted = (t >= 0) & (t < num_classes)
    t = torch.where(counted, t, torch.zeros_like(t))
    p_true = probas.gather(-1, t.unsqueeze(-1)).squeeze(-1)
    zeros = torch.zeros(num_classes, dtype=torch.float32,
                        device=probas.device)
    inter = zeros.index_add(0, t, torch.where(counted, p_true,
                                              torch.zeros_like(p_true)))
    gt_count = zeros.index_add(0, t, counted.float())
    inter, gt_count, p_sum = batch_sum(inter, gt_count, probas.sum(dim=0))
    card = p_sum + gt_count
    dice = (2.0 * inter + smooth) / (card + smooth)
    present = gt_count > 0
    n_present = present.float().sum().clamp(min=1.0)
    return 1.0 - torch.where(present, dice,
                             torch.zeros_like(dice)).sum() / n_present


def focal_bce_loss(logits: torch.Tensor, targets_onehot: torch.Tensor,
                   gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Focal binary CE, the mean over every logit (the equivalent of
    pytorch_modules.nn.FocalBCELoss). targets_onehot: logits' shape, 0/1."""
    logits = logits.float()
    t = targets_onehot.float()
    p = torch.sigmoid(logits)
    # stable BCE with logits
    bce = (torch.maximum(logits, logits.new_zeros(())) - logits * t
           + torch.log1p(torch.exp(-jax_abs(logits))))
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return (alpha_t * (1 - p_t) ** gamma * bce).mean()


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, dim=0)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=0)
    jaccard = 1.0 - intersection / union.clamp(min=1e-9)
    if gt_sorted.shape[0] > 1:
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
    return jaccard


def lovasz_softmax_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Multi-class Lovász-softmax. logits [..., C], labels [...] int.
    Classes absent from the batch contribute zero and are not counted.

    Each class sorts its N errors in descending order with a stable sort,
    so equal errors keep their pixel order, as `lax.top_k` breaks ties in
    the JAX package (the loss does not depend on the order of equal errors;
    its gradient does). One class at a time: a sort of all classes at once
    would hold [C, N] values and int64 indices (2.1 GB at batch 32 and
    513² with 21 classes) besides the saved indices."""
    require_local_batch("the Lovász-softmax loss")
    num_classes = logits.shape[-1]
    probas = torch.softmax(logits.float(), dim=-1).reshape(-1, num_classes)
    labels = labels.reshape(-1)
    losses, present = [], []
    for c in range(num_classes):
        fg = (labels == c).float()
        errors = jax_abs(fg - probas[:, c])
        errors_sorted, perm = torch.sort(errors, descending=True,
                                         stable=True)
        loss_c = torch.dot(errors_sorted, _lovasz_grad(fg[perm]))
        is_present = fg.sum() > 0
        losses.append(torch.where(is_present, loss_c,
                                  torch.zeros_like(loss_c)))
        present.append(is_present)
    return (torch.stack(losses).sum()
            / torch.stack(present).float().sum().clamp(min=1.0))
