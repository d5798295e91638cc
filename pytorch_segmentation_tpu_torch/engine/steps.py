"""The train step (port of `TrainState`, `create_train_state` and
`make_train_step` in pytorch_segmentation_tpu/engine/steps.py).

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
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from ..ops.loss import compute_loss

__all__ = ["TrainState", "create_train_state", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    """model: the module the step runs in train mode. optimizer: an object
    whose `apply(count)` consumes the parameters' `.grad` for update number
    `count` (engine.trainer.make_optimizer). step: optimizer updates so far;
    micro_step: calls so far. grad_acc: f32 gradient sums, one per trainable
    parameter (None when accumulate == 1). ema_params: name -> f32 moving
    average of the parameters (None when EMA is off)."""
    model: torch.nn.Module
    optimizer: object
    step: int = 0
    micro_step: int = 0
    grad_acc: list | None = None
    ema_params: dict | None = None


def _trainable(model):
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def create_train_state(model: torch.nn.Module, optimizer,
                       accumulate: int = 1, ema: bool = False) -> TrainState:
    grad_acc = None
    if accumulate > 1:
        grad_acc = [torch.zeros_like(p, dtype=torch.float32)
                    for _, p in _trainable(model)]
    ema_params = None
    if ema:  # seeded at the initial parameters, as real copies
        ema_params = {n: p.detach().float().clone()
                      for n, p in _trainable(model)}
    return TrainState(model=model, optimizer=optimizer, grad_acc=grad_acc,
                      ema_params=ema_params)


def make_train_step(loss_fn: Callable = compute_loss, accumulate: int = 1,
                    qat: bool = False, ema_decay: float = 0.0,
                    distill_fn: Callable | None = None):
    """Returns `(state, images, segs) -> (state, loss)` over ONE loader
    batch. images: [B, H, W, 3] normalized float, segs: [B, H, W] int, both
    on the model's device; the model sees the images as a channels_last NCHW
    view and `loss_fn` gets NHWC logits.

    ema_decay > 0 keeps `state.ema_params` (from
    `create_train_state(..., ema=True)`) at `d * ema + (1 - d) * params`,
    once per optimizer update.

    Not ported yet: `qat` (ROADMAP: quant.py), `distill_fn` (ROADMAP: losses
    and extras), models whose train-mode forward returns a tuple with
    auxiliary logits, and MoE load-balance losses (ROADMAP: other model
    families, nn/moe.py)."""
    if qat:
        raise NotImplementedError("quantization-aware training is not ported "
                                  "yet (ROADMAP: quant.py)")
    if distill_fn is not None:
        raise NotImplementedError("distillation is not ported yet (ROADMAP: "
                                  "losses and extras, distill_loss)")
    accumulate = max(1, int(accumulate))
    ema_decay = float(ema_decay)

    def update(state, params, grads):
        for (_, p), g in zip(params, grads):
            p.grad = g
        state.optimizer.apply(state.step)
        for _, p in params:
            p.grad = None
        state.step += 1
        if ema_decay:
            if state.ema_params is None:
                raise ValueError("ema_decay > 0 needs create_train_state("
                                 "..., ema=True)")
            ema = [state.ema_params[n] for n, _ in params]
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [p.detach().float()
                                          for _, p in params],
                                    alpha=1.0 - ema_decay)

    def step(state: TrainState, images: torch.Tensor, segs: torch.Tensor):
        model = state.model
        model.train()
        params = _trainable(model)
        logits = model(images.permute(0, 3, 1, 2))
        if isinstance(logits, (tuple, list)):
            raise NotImplementedError(
                "auxiliary heads are not ported yet (ROADMAP: other model "
                "families)")
        loss = loss_fn(logits.permute(0, 2, 3, 1), segs)
        grads = torch.autograd.grad(loss, [p for _, p in params])
        loss = loss.detach()
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

    return step
