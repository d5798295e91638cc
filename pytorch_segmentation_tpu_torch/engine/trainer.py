"""Trainer, the training engine (port of pytorch_segmentation_tpu/engine/
trainer.py).

Contract kept from the JAX package: `Trainer(model, fetcher, loss_fn,
workdir, accumulate, adam, lr, weights, resume, ...)` with the attributes
`.epoch`, `.model`, `.metrics` and the methods `.step()` (one epoch),
`.save(best)` and `.warmup(sizes_hw, batch_size)`.
The model is an `nn.Module` with f32 parameters whose compute dtype is its
own (`dtype=torch.bfloat16` for mixed precision); bf16 needs no loss scaling.
Checkpoints are the port's `.pt` files (engine/checkpoint.py).

`qat=True` trains quantization-aware (the forward in quant.py's "qat"
mode). `mesh` trains data-parallel, one process per card (parallel/), and
`zero` shards the optimizer state over its ranks (parallel/zero.py).
"""

from __future__ import annotations

import copy
import json
import math
import os
import time
from collections.abc import Callable

import torch
import torch.distributed as dist

from ..ops.loss import compute_loss, make_loss_fn
from ..parallel.mesh import (data_sharding, make_mesh, put_replicated_tree,
                             replicated_sharding, require_one_device)
from ..utils.runtime import host_to_device, require_cuda, same_device
from ..utils.weights import load_state, seeded_state_dict
from .checkpoint import save_checkpoint
from .steps import create_train_state, make_train_step

__all__ = ["Trainer", "OptimizerChain", "make_lr_schedule", "make_optimizer"]


def _polynomial(init: float, end: float, power: float, steps: int):
    """optax.polynomial_schedule: from `init` to `end` over `steps` counts."""
    def schedule(count):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end
    return schedule


def _join(first, second, boundary: int):
    """optax.join_schedules of two: `second` counts from the boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_lr_schedule(name: str, lr: float, warmup_steps: int = 0,
                     total_steps: int | None = None) -> Callable[[int], float]:
    """LR as a function of the OPTIMIZER-UPDATE count (= loader batches /
    accumulate), equal to the optax schedules the JAX package builds:
    'constant' (with an optional linear warm-up), 'cosine' (linear warm-up,
    then cosine decay to 1% of `lr`) and 'poly' (the (1 - s/T)^0.9 DeepLab
    schedule, after an optional linear warm-up)."""
    if name == "cosine":
        decay_steps = max((total_steps or 10000) - warmup_steps, 1)
        warm = max(warmup_steps, 1)
        cosine_steps = warmup_steps + decay_steps - warm
        alpha = 0.01  # end_value / peak_value

        def cosine(count):
            if cosine_steps <= 0:
                return lr * alpha
            t = min(max(count, 0), cosine_steps) / cosine_steps
            return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t))
                         + alpha)
        return _join(_polynomial(0.0, lr, 1, warm), cosine, warm)
    if name == "poly":
        decay_steps = max((total_steps or 10000) - warmup_steps, 1)
        poly = _polynomial(lr, 0.0, 0.9, decay_steps)
        if warmup_steps:
            return _join(_polynomial(0.0, lr, 1, warmup_steps), poly,
                         warmup_steps)
        return poly
    if name != "constant":
        raise ValueError(f"unknown lr schedule {name!r}")
    if warmup_steps:
        return _polynomial(0.0, lr, 1, warmup_steps)
    return lambda count: lr


class OptimizerChain:
    """The JAX trainer's optax chain, in its order: clip the RAW gradients'
    global norm, add the coupled weight decay to the gradients, then SGD
    with momentum (no Nesterov) or Adam at the scheduled rate. `apply(count)`
    consumes the parameters' `.grad` for update number `count`. The decay
    and the update rule are torch.optim's (same arithmetic as optax's)."""

    def __init__(self, params, schedule: Callable[[int], float],
                 adam: bool = False, momentum: float = 0.9,
                 weight_decay: float = 0.0, clip_grad: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.clip_grad = float(clip_grad)
        if adam:
            self.inner = torch.optim.Adam(self.params, lr=schedule(0),
                                          weight_decay=weight_decay)
        else:
            self.inner = torch.optim.SGD(self.params, lr=schedule(0),
                                         momentum=momentum, nesterov=False,
                                         weight_decay=weight_decay)

    @torch.no_grad()
    def apply(self, count: int) -> None:
        if self.clip_grad:
            # optax.clip_by_global_norm: untouched below the bound, else
            # scaled onto it; no host sync
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                self.clip_grad / norm)
            torch._foreach_mul_(grads, scale)
        lr = float(self.schedule(count))
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def state_tensors(self) -> list:
        """(parameter index, key, tensor) of every tensor of the optimizer
        state (the momentum, or Adam's moments and step), in the
        parameters' order."""
        return [(i, k, v) for i, p in enumerate(self.params)
                for k, v in self.inner.state.get(p, {}).items()
                if isinstance(v, torch.Tensor)]

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)


def make_optimizer(params, lr: float = 1e-3, adam: bool = False,
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   clip_grad: float = 0.0, lr_schedule: str = "constant",
                   warmup_steps: int = 0,
                   total_steps: int | None = None) -> OptimizerChain:
    schedule = make_lr_schedule(lr_schedule, lr, warmup_steps, total_steps)
    return OptimizerChain(params, schedule, adam=adam, momentum=momentum,
                          weight_decay=weight_decay, clip_grad=clip_grad)


class Trainer:
    """fetcher: an iterable with a length that yields `(images, segs,
    valid)` per batch: normalized float images [B, H, W, 3], integer labels
    [B, H, W] (numpy arrays or tensors) and the count of real samples.

    `device` is explicit: None means the first CUDA device and raises when
    there is none; the CPU is used only when asked for. Without `weights`
    the model starts from `seeded_state_dict(model, seed, init="train")`.

    resume=True restores what the JAX Trainer restores from
    `<workdir>/last.pt` (written by `save`): the model, the optimizer state
    with its update count (the LR schedule's position), `epoch`, the best
    mIoU and the EMA weights. As in the JAX package, the fetcher's batch
    counter and the loader's epoch are not restored. profile=True writes a
    torch.profiler trace of steps 2-6 of the first epoch to
    `<log_dir>/profile/trace.json`.

    `aux_weight` scales the auxiliary head's loss of a model whose
    train-mode forward returns `(logits, aux)` (`make_train_step`); the
    deferred upsample's twin keeps the aux head, and each head's loss goes
    through the fused upsample+CE at its own resolution. A warm start
    (`weights`) from a checkpoint without the head leaves the head at its
    seeded start.

    `distill_fn(images) -> teacher logits` (NHWC, from a frozen teacher on
    `device`) adds `distill_weight` times the T^2-scaled KL term at
    temperature `distill_temp` to the main head's loss (`make_train_step`).
    With the default CE the deferred upsample stays on, so the student's
    main logits are the low-resolution ones: build the teacher with
    `full_res_output=False` too (`distill_loss` resizes a teacher grid that
    differs).

    `qat=True`: quantization-aware training (`make_train_step(qat=True)`),
    straight-through fake quant of every eligible conv, so that the int8
    serving path's rounding costs little accuracy.

    `mixed_precision` is taken as the JAX Trainer takes it, so that the
    train CLI's call works, and ignored: the model's `dtype` decides the
    compute dtype, as in the JAX package.

    `mesh` (`parallel.make_mesh()`; by default the process group when one is
    initialized, as the JAX Trainer's default mesh spans every device):
    data-parallel training, one process per card. The fetcher yields this
    rank's shard of each global batch (`DataLoader(rank=, world_size=)`),
    its `PostFetch` gets the mesh's `data_sharding`, every rank starts from
    rank 0's parameters and buffers (broadcast) and takes the same steps
    (`make_train_step(mesh=)`). Only rank 0 prints and writes `log.jsonl`,
    `last.pt` and `best.pt`; every rank resumes from the file. `zero=True`
    keeps only this rank's shard of the optimizer state, the accumulator and
    the EMA (`parallel.zero.ZeroOptimizer`); `save` then gathers the full
    state, so a `.pt` does not depend on the rank count, and `save` and
    `ema_model` are collectives that every rank calls. With one rank `zero`
    is the replicated path.
    """

    def __init__(self, model: torch.nn.Module, fetcher,
                 loss_fn: Callable = compute_loss, workdir: str = "weights",
                 accumulate: int = 1, adam: bool = False, lr: float = 1e-3,
                 weights: str = "", momentum: float = 0.9,
                 weight_decay: float = 0.0, clip_grad: float = 0.0,
                 seed: int = 0, log: bool = True, log_dir: str = "runs",
                 resume: bool = False, profile: bool = False,
                 defer_upsample: bool = True, lr_schedule: str = "constant",
                 warmup_steps: int = 0, total_steps: int | None = None,
                 ema_decay: float = 0.0, mixed_precision: bool = False,
                 aux_weight: float = 0.4, distill_fn: Callable | None = None,
                 distill_weight: float = 0.0, distill_temp: float = 2.0,
                 qat: bool = False, mesh=None, zero: bool = False,
                 device=None, **unknown):
        if unknown:
            raise TypeError(f"Trainer got an unknown option "
                            f"{next(iter(unknown))!r}")
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(None if device is None else (device,))
        if mesh is not None:
            at = require_one_device(mesh, "the Trainer")
            if device is not None and not same_device(device, at):
                raise ValueError(f"the Trainer's device {device} is not its "
                                 f"mesh's {at}")
            device = at
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.zero = bool(zero) and mesh is not None and mesh.world > 1
        self.module = model
        self.fetcher = fetcher
        self.workdir = workdir
        self.accumulate = max(1, int(accumulate))
        self.epoch = 0
        self.metrics = 0.0  # best val mIoU so far
        self.log = log and self.rank == 0
        self.log_dir = log_dir
        self.profile = profile
        self.ema_decay = float(ema_decay)
        self.qat = bool(qat)

        # warm start tolerates modules the checkpoint lacks (they keep
        # their seeded start); a key the model lacks is an error. The seeded
        # start is drawn only where something keeps it: resume loads every
        # key
        start = load_state(weights) if weights else {}
        if not resume and set(model.state_dict()) - set(start):
            model.load_state_dict(seeded_state_dict(model, seed,
                                                    init="train"))
        if start:
            extra = model.load_state_dict(start, strict=False).unexpected_keys
            if extra:
                raise ValueError(f"{weights}: keys the model lacks: {extra}")
        ckpt = None
        if resume:
            ckpt = torch.load(os.path.join(workdir, "last.pt"),
                              map_location="cpu", weights_only=True)
            model.load_state_dict(ckpt["model"])
            self.epoch = int(ckpt["epoch"])
            self.metrics = float(ckpt["best_miou"])
        model.to(self.device, memory_format=torch.channels_last)
        if mesh is not None:
            # rank 0's values in every replica (the JAX Trainer's
            # put_replicated_tree); the fetcher's PostFetch augments this
            # rank's shard with a stream of its own
            put_replicated_tree(replicated_sharding(mesh), model)
            pf = getattr(fetcher, "post_fetch_fn", None)
            if pf is not None and getattr(pf, "sharding", False) is None:
                pf.sharding = data_sharding(mesh)

        # Train on low-resolution logits and fold the model's trailing
        # bilinear upsample into the loss (the fused upsample+CE kernel on
        # the card): the same function, since the upsample is linear and
        # last, but full-resolution logits and their gradients never reach
        # device memory. The twin shares every parameter and buffer with
        # `model`. Not done for custom loss functions (unknown upsample
        # semantics).
        self._train_module = model
        if (defer_upsample and loss_fn is compute_loss
                and getattr(model, "full_res_output", None) is True):
            self._train_module = copy.copy(model)
            self._train_module.full_res_output = False
            loss_fn = make_loss_fn(
                align_corners=getattr(model, "up_align_corners", True))

        self._optimizer_options = dict(
            lr=lr, adam=adam, momentum=momentum, weight_decay=weight_decay,
            clip_grad=clip_grad, lr_schedule=lr_schedule,
            warmup_steps=warmup_steps, total_steps=total_steps)
        params = [p for p in model.parameters() if p.requires_grad]
        if self.zero:
            from ..parallel.zero import ZeroOptimizer
            inner = {**self._optimizer_options, "clip_grad": 0.0}
            self.optimizer = ZeroOptimizer(
                params, mesh, lambda shards: make_optimizer(shards, **inner),
                clip_grad=clip_grad)
        else:
            self.optimizer = make_optimizer(params,
                                            **self._optimizer_options)
        self.state = create_train_state(self._train_module, self.optimizer,
                                        accumulate=self.accumulate,
                                        ema=self.ema_decay > 0)
        if ckpt is not None:
            self.optimizer.load_state_dict(ckpt["optimizer"])
            # the JAX optimizer state carries its update count; a partly
            # summed accumulation is not saved, so it restarts here
            self.state.step = int(ckpt["step"])
            self.state.micro_step = self.state.step * self.accumulate
            if self.ema_decay > 0 and ckpt["ema"] is not None:
                names = list(self.state.ema_params)
                values = [ckpt["ema"][n] for n in names]
                if self.zero:
                    values = self.optimizer.shard(values)
                for name, value in zip(names, values):
                    self.state.ema_params[name].copy_(value)
        self._train_step = make_train_step(loss_fn=loss_fn,
                                           accumulate=self.accumulate,
                                           qat=self.qat,
                                           ema_decay=self.ema_decay,
                                           aux_weight=aux_weight,
                                           distill_fn=distill_fn,
                                           distill_weight=distill_weight,
                                           distill_temp=distill_temp,
                                           mesh=mesh)

    @property
    def model(self) -> torch.nn.Module:
        """The module handed in (live parameters), in eval mode."""
        return self.module.eval()

    @property
    def ema_model(self) -> torch.nn.Module:
        """A copy of the model over the EMA-averaged parameters, in eval
        mode; the model itself when EMA is off. BN running statistics are
        the live ones: they already are a moving average."""
        if self.state.ema_params is None:
            return self.model
        twin = copy.deepcopy(self.module)
        twin.load_state_dict(self._full_ema(), strict=False)
        return twin.eval()

    def _full_ema(self):
        """The EMA weights at full size (under ZeRO gathered from every
        rank's shards: a collective)."""
        ema = self.state.ema_params
        if ema is None or not self.zero:
            return ema
        names = list(ema)
        return dict(zip(names, self.optimizer.gather_tensors(
            [ema[n] for n in names])))

    def _to_device(self, array):
        return host_to_device(array, self.device)

    def warmup(self, sizes_hw, batch_size: int, label_hw=None) -> None:
        """One train step on zeros per input size in `sizes_hw` (the
        multi-scale set, data/resize_host.py), with labels at the dataset's
        base size (default `label_hw`), so that the kernel builds and
        cuDNN's algorithm choices of every size happen before the first
        epoch. The steps run on a throwaway copy of the model, optimizer
        and EMA: the live ones are not touched."""
        if label_hw is None:
            w, h = self.fetcher.loader.dataset.img_size
            label_hw = (h, w)
        module = copy.deepcopy(self._train_module)
        optimizer = make_optimizer(
            [p for p in module.parameters() if p.requires_grad],
            **self._optimizer_options)
        state = create_train_state(module, optimizer,
                                   accumulate=self.accumulate,
                                   ema=self.ema_decay > 0)
        for hh, ww in sizes_hw:
            images = torch.zeros((batch_size, hh, ww, 3), device=self.device)
            segs = torch.zeros((batch_size, *label_hw), dtype=torch.int32,
                               device=self.device)
            state, loss = self._train_step(state, images, segs)
            float(loss)  # wait for the step before the next size
            if self.log:
                print(f"warmup: compiled train step @ {hh}x{ww}")

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def _stop_profile(self, prof) -> None:
        prof.stop()
        path = os.path.join(self.log_dir, "profile")
        os.makedirs(path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))

    def step(self) -> float:
        """Run one training epoch; returns its mean loss."""
        running_loss = 0.0
        n = 0
        images_seen = 0
        pending_loss = None
        prof = None
        t0 = time.time()
        for images, segs, valid in self.fetcher:
            if self.profile and self.epoch == 0 and n == 2:
                prof = self._profiler()
                prof.start()
            self.state, loss = self._train_step(
                self.state, self._to_device(images), self._to_device(segs))
            n += 1
            images_seen += int(valid)
            # read the PREVIOUS step's loss: the host sync then overlaps
            # this step's device work instead of waiting after it
            if pending_loss is not None:
                running_loss += float(pending_loss)
            pending_loss = loss
            if prof is not None and n == 7:
                self._stop_profile(prof)
                prof = None
        if pending_loss is not None:
            running_loss += float(pending_loss)
        if prof is not None:
            self._stop_profile(prof)
        self.epoch += 1
        dt = time.time() - t0
        mean_loss = running_loss / max(n, 1)
        if self.log and n:
            print(f"epoch {self.epoch - 1}: {images_seen / dt:.1f} img/s, "
                  f"loss {mean_loss:.4f}")
        self.log_record(epoch=self.epoch - 1, loss=mean_loss,
                        images_per_sec=images_seen / max(dt, 1e-9),
                        seconds=dt,
                        # the scheduled lr at the current update count
                        lr=float(self.optimizer.schedule(self.state.step)),
                        steps=n)
        return mean_loss

    def log_record(self, **record) -> None:
        """Append one JSON line to <log_dir>/log.jsonl (rank 0 only)."""
        if self.rank != 0:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        record.setdefault("time", time.time())
        with open(os.path.join(self.log_dir, "log.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def save(self, best: bool = False) -> None:
        """Write last.pt (and best.pt when `best`) under `workdir`; under a
        mesh every rank calls it and rank 0 writes."""
        kw = dict(model_state=self.module.state_dict(),
                  optimizer_state=self.optimizer.state_dict(),
                  step=self.state.step, epoch=self.epoch,
                  best_miou=self.metrics, ema=self._full_ema())
        if self.rank != 0:
            return
        save_checkpoint(os.path.join(self.workdir, "last.pt"), **kw)
        if best:
            save_checkpoint(os.path.join(self.workdir, "best.pt"), **kw)
