"""The train, eval and predict steps (port of `TrainState`,
`create_train_state`, `make_train_step`, `sample_valid_mask`, `tiled_logits`,
`make_eval_step` and `make_predict_step` in
pytorch_segmentation_tpu/engine/steps.py).

One call runs forward and backward on one loader batch and, every
`accumulate`-th call, one optimizer update. With accumulate=k the gradients
of k consecutive calls are summed in a persistent f32 accumulator and their
mean is applied on the k-th call; BN statistics are per call, and
`state.step` counts optimizer updates, so LR schedules step per update. The
JAX step selects "apply or skip" branchlessly because a conditional region
with collectives deadlocks its SPMD programs; here a plain `if` on the
host-side call counter does it. The step makes no host sync: the loss comes
back as a 0-d tensor on the model's device.

Unlike the JAX state, a `TrainState` is mutable: the model's parameters, the
optimizer state, the accumulator and the EMA weights are updated in place,
and the step returns the same object.

Under a mesh (`make_train_step(mesh=)`, one process per card) each rank
steps on its shard of the global batch and the step computes what one
process computes on the concatenated batch, up to rounding, as the JAX
package's global program does under pjit: BatchNorm's moments and the loss
ratios' sums are taken over every rank inside the forward
(`parallel.mesh.batch_statistics_over`), the gradients and the loss are
averaged over the ranks after the backward (one bucketed all-reduce a
call), and then each rank applies the same update. Under ZeRO
(`parallel.zero.ZeroOptimizer`) the optimizer state, the accumulator and the
EMA hold this rank's shards only, and the updated shards are all-gathered
into the parameters.

The eval and predict steps take the eval-mode module itself where the JAX
ones take a state. They run under `torch.inference_mode()`, make no host
sync and return tensors on the model's device. Eval masks padded samples
(eval batches have a fixed size; see data/loader.py) out of the loss and the
confusion counts.

With the debug-NaN switch on (`utils/runtime.set_debug_nans`, the train
CLI's `--debug-nans`) each step checks what it returns and, for the train
step, every tensor it updated (the parameters, the buffers, the optimizer
state, the gradient sums and the EMA) and raises a `FloatingPointError`
naming the first that holds a NaN, as the JAX package's steps do under
`jax_debug_nans`. The check reads the flags back in one host sync and
changes no value.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
import torch.nn.functional as F

from ..ops.boundary import boundary_confusion, boundary_pixels
from ..ops.kernels.eval_confusion import fused_eval_confusion
from ..ops.kernels.softmax_ce import fused_upsample_ce_per_sample
from ..ops.kernels.upsample_argmax import (fused_upsample_argmax,
                                           upsample_argmax_reference)
from ..ops.loss import compute_loss
from ..ops.metrics import sample_valid_mask
from ..ops.resize import resize_bilinear
from ..ops.tta import normalize_tta_scales, tta_logits
from ..parallel.mesh import (all_reduce_mean_, batch_statistics_over,
                             require_one_device)
from ..quant import quant_mode, quantized_forward
from ..utils.runtime import check_nans, debug_nans_enabled

__all__ = ["TrainState", "create_train_state", "distill_loss",
           "make_train_step",
           "sample_valid_mask", "nhwc_forward", "tiled_logits",
           "require_eval_mode", "make_eval_step", "make_predict_step"]


@dataclasses.dataclass
class TrainState:
    """model: the module the step runs in train mode. optimizer: an object
    whose `apply(count)` consumes the parameters' `.grad` for update number
    `count` (engine.trainer.make_optimizer), or a `parallel.zero.
    ZeroOptimizer`, whose own shard tensors take the `.grad`. step: optimizer
    updates so far; micro_step: calls so far. grad_acc: f32 gradient sums,
    one per trainable parameter (None when accumulate == 1). ema_params:
    name -> f32 moving average of the parameters (None when EMA is off).
    Under ZeRO grad_acc and ema_params hold this rank's shards."""
    model: torch.nn.Module
    optimizer: object
    step: int = 0
    micro_step: int = 0
    grad_acc: list | None = None
    ema_params: dict | None = None


def require_eval_mode(modules, what: str) -> None:
    """Raise a ValueError naming `what` if any of `modules` (a model's
    `.modules()`, or a tuple of them taken once) is in train mode. A
    module's own flag is not enough: a shallow copy (the Trainer's stride-4
    twin) shares its children, so a train step on the copy puts them back
    in train mode while the module's own flag stays False."""
    if any(m.training for m in modules):
        raise ValueError(f"{what} needs an eval-mode module: a submodule is "
                         f"in train mode (BatchNorm would normalize by the "
                         f"batch)")


def _trainable(model):
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def _zero_shard(optimizer):
    """A ZeRO optimizer's `shard` (this rank's part of each full-size
    tensor), or None for a replicated one."""
    return getattr(optimizer, "shard", None)


def _check_train_step(state: TrainState, params, loss) -> None:
    """The debug-NaN check of a train step: the loss, then every parameter,
    buffer, optimizer-state tensor, gradient sum and EMA of `state`."""
    names = [n for n, _ in params]
    named = [("the loss", loss)]
    named += [(f"parameter {n}", p)
              for n, p in state.model.named_parameters()]
    named += [(f"buffer {n}", b) for n, b in state.model.named_buffers()]
    named += [(f"optimizer state {k} of {names[i]}", v)
              for i, k, v in state.optimizer.state_tensors()]
    named += [(f"gradient sum of {n}", g)
              for n, g in zip(names, state.grad_acc or ())]
    named += [(f"EMA of {n}", v)
              for n, v in (state.ema_params or {}).items()]
    check_nans(named, "the train step")


def create_train_state(model: torch.nn.Module, optimizer,
                       accumulate: int = 1, ema: bool = False) -> TrainState:
    trainable = _trainable(model)
    values = [p.detach() for _, p in trainable]
    shard = _zero_shard(optimizer)
    if shard is not None:
        values = shard(values)
    grad_acc = None
    if accumulate > 1:
        grad_acc = [torch.zeros_like(v, dtype=torch.float32) for v in values]
    ema_params = None
    if ema:  # seeded at the initial parameters, as real copies
        ema_params = {n: v.float().clone()
                      for (n, _), v in zip(trainable, values)}
    return TrainState(model=model, optimizer=optimizer, grad_acc=grad_acc,
                      ema_params=ema_params)


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 temp: float = 2.0) -> torch.Tensor:
    """Hinton et al.'s knowledge distillation: T^2 * KL(softmax(t/T) ||
    softmax(s/T)), the mean over pixels. Logits are [B, h, w, C]; the
    teacher's grid is bilinearly resized (align_corners=False) to the
    student's where the two differ. f32 softmaxes."""
    if tuple(teacher_logits.shape[1:3]) != tuple(student_logits.shape[1:3]):
        teacher_logits = resize_bilinear(teacher_logits.float(),
                                         student_logits.shape[1:3],
                                         align_corners=False)
    t = teacher_logits.float() / temp
    s = student_logits.float() / temp
    kl = (torch.softmax(t, dim=-1) * (torch.log_softmax(t, dim=-1)
                                      - torch.log_softmax(s, dim=-1))).sum(-1)
    return (temp * temp) * kl.mean()


def make_train_step(loss_fn: Callable = compute_loss, accumulate: int = 1,
                    qat: bool = False, ema_decay: float = 0.0,
                    aux_weight: float = 0.4,
                    distill_fn: Callable | None = None,
                    distill_weight: float = 0.0, distill_temp: float = 2.0,
                    mesh=None):
    """Returns `(state, images, segs) -> (state, loss)` over ONE loader
    batch. images: [B, H, W, 3] normalized float, segs: [B, H, W] int, both
    on the model's device; the model sees the images as a channels_last NCHW
    view and `loss_fn` gets NHWC logits.

    ema_decay > 0 keeps `state.ema_params` (from
    `create_train_state(..., ema=True)`) at `d * ema + (1 - d) * params`,
    once per optimizer update.

    A model whose train-mode forward returns `(logits, aux)` (PSPNet and
    FastFCN with aux=True; `aux` one tensor or a tuple of them) is trained
    on `loss_fn(logits) + aux_weight * sum(loss_fn(a) for a in aux)`: the
    same criterion on each head, each at its own resolution (through
    `make_loss_fn`, one fused upsample+CE forward and backward a head). A
    model whose train-mode forward returns a dict (MaskFormer's
    predictions) is trained on `loss_fn(outputs, segs)`, the dict as it is:
    no layout change, no `aux_weight`.

    distill_fn(images) -> a frozen teacher's NHWC logits enables knowledge
    distillation: with distill_weight > 0 the loss gains distill_weight *
    `distill_loss(main logits, teacher logits, distill_temp)`. The teacher
    runs under `torch.no_grad()` on the step's images; the term applies to
    the main head's logits only, never to an aux head's.

    qat=True runs the forward in "qat" mode (quant.py): every eligible
    ConvNormAct convolves straight-through fake-quantized operands, so the
    loss sees the int8 serving path's rounding while the gradients pass it
    unchanged.

    mesh (`parallel.mesh.make_mesh`, one device a process): the images and
    labels are this rank's shard of the global batch; BatchNorm's statistics
    and the loss ratios span every rank, and the gradients and the returned
    loss are their mean over the ranks (the module docstring). Every rank
    calls the step, in the same order.

    Not ported yet: the MoE load-balance losses (ROADMAP queue 1 item 10,
    nn/moe.py)."""
    group, world = None, 1
    if mesh is not None:
        require_one_device(mesh, "the train step")
        group, world = mesh.group, mesh.world
    distill = distill_fn is not None and distill_weight > 0
    distill_weight = float(distill_weight)
    accumulate = max(1, int(accumulate))
    ema_decay = float(ema_decay)
    aux_weight = float(aux_weight)

    def update(state, params, grads):
        zero = _zero_shard(state.optimizer) is not None
        # under ZeRO the optimizer updates its shards, then gathers them
        targets = (state.optimizer.params if zero
                   else [p for _, p in params])
        for p, g in zip(targets, grads):
            p.grad = g
        state.optimizer.apply(state.step)
        for p in targets:
            p.grad = None
        if zero:
            state.optimizer.gather()
        state.step += 1
        if ema_decay:
            if state.ema_params is None:
                raise ValueError("ema_decay > 0 needs create_train_state("
                                 "..., ema=True)")
            ema = [state.ema_params[n] for n, _ in params]
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [p.detach().float()
                                          for p in targets],
                                    alpha=1.0 - ema_decay)

    def forward_loss(model, images, segs):
        with quant_mode("qat" if qat else None):
            logits = model(images.permute(0, 3, 1, 2))
        if isinstance(logits, dict):
            if distill:
                raise ValueError("distillation needs per-pixel logits; this "
                                 "model's train-mode forward returned a "
                                 "dict")
            return loss_fn(logits, segs)
        if isinstance(logits, (tuple, list)):
            main, aux = logits
            main = main.permute(0, 2, 3, 1)
            auxs = aux if isinstance(aux, (tuple, list)) else (aux,)
            loss = loss_fn(main, segs) + aux_weight * sum(
                loss_fn(a.permute(0, 2, 3, 1), segs) for a in auxs)
        else:
            main = logits.permute(0, 2, 3, 1)
            loss = loss_fn(main, segs)
        if distill:
            with torch.no_grad():
                teacher = distill_fn(images)
            loss = loss + distill_weight * distill_loss(main, teacher,
                                                        distill_temp)
        return loss

    def run_step(state: TrainState, images: torch.Tensor,
                 segs: torch.Tensor):
        model = state.model
        model.train()
        params = _trainable(model)
        with batch_statistics_over(group):
            loss = forward_loss(model, images, segs)
        grads = list(torch.autograd.grad(loss, [p for _, p in params]))
        loss = loss.detach()
        if group is not None:
            loss = loss.clone()
            all_reduce_mean_(grads + [loss], group, world)
        shard = _zero_shard(state.optimizer)
        if shard is not None:
            grads = shard(grads)
        if accumulate == 1:
            update(state, params, grads)
            state.micro_step += 1
            return state, loss

        if state.grad_acc is None:
            raise ValueError("accumulate > 1 needs a grad accumulator: call "
                             "create_train_state(..., accumulate=k)")
        torch._foreach_add_(state.grad_acc, [g.float() for g in grads])
        state.micro_step += 1
        if state.micro_step % accumulate == 0:
            update(state, params,
                   torch._foreach_div(state.grad_acc, float(accumulate)))
            torch._foreach_zero_(state.grad_acc)
        return state, loss

    def step(state: TrainState, images: torch.Tensor, segs: torch.Tensor):
        state, loss = run_step(state, images, segs)
        if debug_nans_enabled():
            _check_train_step(state, _trainable(state.model), loss)
        return state, loss

    return step


def nhwc_forward(model: torch.nn.Module):
    """`fwd(images [B, H, W, 3]) -> logits [B, h, w, C]` around a module that
    takes and returns NCHW: the one place the eval and serving paths permute.
    Both permutes are views (NHWC memory is the channels_last layout of the
    NCHW view), so nothing is copied."""
    def fwd(x):
        logits = model(x.permute(0, 3, 1, 2))
        if isinstance(logits, (tuple, list)):
            raise ValueError(
                "the eval and serving paths take one output: this module's "
                "forward returned a tuple (an auxiliary head returns one in "
                "train mode only)")
        return logits.permute(0, 2, 3, 1)
    return fwd


def tiled_logits(fwd_tile, images: torch.Tensor, tile_hw, overlap: float,
                 edge_pad: float = 0.0) -> torch.Tensor:
    """Sliding-window logits at the INPUT's resolution: run `fwd_tile`
    (normalized tile [B, th, tw, 3] -> logits [B, th, tw, C]) over a static
    grid of overlapping tile_hw windows, average overlapping logits on a
    canvas, and return [B, H, W, C] f32.

    The mmseg "slide" inference mode: when the eval resolution exceeds the
    training resolution, whole-image forwards are out of distribution for
    heads with a fixed receptive field (the ASPP pool branch), so the
    standard protocol evaluates training-resolution windows instead. Inputs
    smaller than a tile are padded with `edge_pad` (0 = the ImageNet mean of
    normalized images) and cropped back."""
    from ..inference import sum_tile_logits
    h, w = images.shape[1:3]
    th, tw = int(tile_hw[0]), int(tile_hw[1])
    x = F.pad(images, (0, 0, 0, max(w, tw) - w, 0, max(h, th) - h),
              value=edge_pad)
    canvas, count = sum_tile_logits(fwd_tile, x, (th, tw), overlap)
    return canvas[:, :h, :w] / count[:, :h, :w]


# what the eval step returns, in order
_EVAL_OUTPUTS = ("the loss", "the true positives", "the false negatives",
                 "the false positives", "the boundary intersections",
                 "the boundary unions")


def make_eval_step(num_classes: int, align_corners: bool = True,
                   use_kernels: bool = True, quant: bool = False,
                   tta_flip: bool = False, tta_scales: tuple = (),
                   ignore_index: int | None = None,
                   tile: tuple | None = None, tile_overlap: float = 1 / 3,
                   boundary_ratio: float | None = None):
    """Returns `(model, images, segs, valid) -> (loss, tp, fn, fp)` with
    padded samples masked out of the loss and the confusion counts. model: an
    eval-mode module whose logits may be smaller than the labels (the
    stride-4 twin of a `full_res_output` model); images [B, H, W, 3]
    normalized float and segs [B, H, W] int on the model's device; `valid`
    the count of real samples (the first `valid` of the batch) or a
    per-sample bool mask [B]. loss is a 0-d f32 tensor, the counts f32 [C].

    Two routes, chosen by the options alone. With logits smaller than the
    labels and none of `ignore_index`, `tile`, `boundary_ratio` set, the
    loss is the masked mean of `fused_upsample_ce_per_sample` and the counts
    come from `fused_eval_confusion`: on the card two hand-written kernels
    that never write full-resolution logits. Otherwise the plain tail: f32
    upsample, logsumexp, per-sample mean, argmax, one bincount.
    `use_kernels=False` forces the plain tail (for holding one route against
    the other). The routes differ on a label outside [0, C) with no
    `ignore_index`: the fused route counts it as a false positive of the
    predicted class and its true logit as 0; the plain tail drops the pixel
    from the counts and its loss is NaN, as in the JAX package for a label
    >= C (a negative label wraps around there and is not held to it).

    tta_flip / tta_scales: test-time augmentation (ops/tta.py), averaged
    logits flow through either route. ignore_index: those pixels leave both
    the loss (per-sample mean over the valid pixels) and the counts. tile=(H,
    W): mmseg "slide" evaluation, `tiled_logits` with `tile_overlap`; TTA
    composes per tile. boundary_ratio=R: the step also returns per-class
    Boundary IoU intersection and union sums (ops/boundary.py), six values
    in all. Each of the three forces the plain tail.

    quant=True evaluates the int8 forward (quant.py): dynamic activation
    scales, or the calibrated ones that the step's fifth argument
    `quant_stats` (from quant.calibrate) brings."""
    tta_scales = normalize_tta_scales(tta_scales)
    if tile is not None:
        tile = (int(tile[0]), int(tile[1]))
    fused = (use_kernels and ignore_index is None and tile is None
             and boundary_ratio is None)

    @torch.inference_mode()
    def step(model: torch.nn.Module, images: torch.Tensor,
             segs: torch.Tensor, valid, quant_stats=None):
        require_eval_mode(model.modules(), "the eval step")
        fwd = nhwc_forward(model)
        if quant:
            fwd = quantized_forward(fwd, model, quant_stats)

        def averaged(x):
            return tta_logits(fwd, x, scales=tta_scales, flip=tta_flip,
                              align_corners=align_corners)

        if tile is not None:
            def fwd_tile(x):
                return resize_bilinear(averaged(x).float(), tile,
                                       align_corners=align_corners)
            logits = tiled_logits(fwd_tile, images, tile, tile_overlap)
        else:
            logits = averaged(images)
        b, th, tw = segs.shape
        mask = sample_valid_mask(valid, b, logits.device)
        mask_f = mask.float()
        if fused and tuple(logits.shape[1:3]) != (th, tw):
            per_sample = fused_upsample_ce_per_sample(
                logits, segs, align_corners=align_corners)
            loss = (per_sample * mask_f).sum() / mask_f.sum().clamp(min=1.0)
            return (loss, *fused_eval_confusion(
                logits, segs, mask, align_corners=align_corners))

        up = resize_bilinear(logits.float(), (th, tw),
                             align_corners=align_corners)
        lse = torch.logsumexp(up, dim=-1)
        labels = segs.long()
        pix = mask[:, None, None]  # pixels of real samples, not ignored
        if ignore_index is not None:
            pix_valid = segs != ignore_index
            labels = torch.where(pix_valid, labels, torch.zeros_like(labels))
            pix = pix & pix_valid
        inside = (labels >= 0) & (labels < num_classes)
        true_logit = up.gather(
            -1, labels.clamp(0, num_classes - 1).unsqueeze(-1)).squeeze(-1)
        pixel_loss = lse - torch.where(
            inside, true_logit, torch.full_like(true_logit, float("nan")))
        if ignore_index is not None:
            # per-sample mean over the VALID pixels only (torch
            # cross_entropy(ignore_index=) semantics per sample)
            pv = pix_valid.float()
            per_sample = (pixel_loss * pv).sum(dim=(1, 2)) / pv.sum(
                dim=(1, 2)).clamp(min=1.0)
        else:
            per_sample = pixel_loss.mean(dim=(1, 2))
        loss = (per_sample * mask_f).sum() / mask_f.sum().clamp(min=1.0)
        pred = torch.argmax(up, dim=-1)
        # one bincount over (C+1)^2: padded samples, ignored pixels and
        # labels outside [0, C) go to the extra bucket, which is cropped
        nc1 = num_classes + 1
        counted = pix & inside
        bucket = torch.full_like(pred, num_classes)
        keys = (torch.where(counted, labels, bucket) * nc1
                + torch.where(counted, pred, bucket))
        cm = torch.bincount(keys.reshape(-1), minlength=nc1 * nc1).reshape(
            nc1, nc1)[:num_classes, :num_classes]
        tp = cm.diagonal()
        out = (loss, tp.float(), (cm.sum(dim=1) - tp).float(),
               (cm.sum(dim=0) - tp).float())
        if boundary_ratio is not None:
            out += boundary_confusion(
                pred, segs, num_classes,
                boundary_pixels(th, tw, boundary_ratio), valid=pix)
        return out

    def checked_step(model, images, segs, valid, quant_stats=None):
        out = step(model, images, segs, valid, quant_stats)
        if debug_nans_enabled():
            check_nans(zip(_EVAL_OUTPUTS, out), "the eval step")
        return out

    return checked_step


def make_predict_step(align_corners: bool = True, use_kernels: bool = True):
    """`(model, images [B, H, W, 3], out_hw) -> int32 argmax mask
    [B, *out_hw]` (serving and the eval loop's first-batch picture). Logits
    smaller than `out_hw` go through `fused_upsample_argmax`, on the card one
    kernel that never writes the full-resolution logits;
    `use_kernels=False` takes its plain version."""
    argmax = (fused_upsample_argmax if use_kernels
              else upsample_argmax_reference)

    @torch.inference_mode()
    def predict(model: torch.nn.Module, images: torch.Tensor, out_hw):
        require_eval_mode(model.modules(), "the predict step")
        logits = nhwc_forward(model)(images)
        out_hw = (int(out_hw[0]), int(out_hw[1]))
        if tuple(logits.shape[1:3]) == out_hw:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return argmax(logits, out_hw, align_corners=align_corners)

    return predict
