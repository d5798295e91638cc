"""The ranks of tests/test_torch_parallel.py: scenarios that two gloo
processes run together over a mesh, and the same scenarios in one process
on the concatenated global batch, which the tests hold them against.

This module imports torch and the port only: a spawned rank must not import
JAX, and tests/conftest.py and the other port helpers do. Sizes are tiny
(16x16 images, 8 channels, f32) so that the whole set runs in seconds.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from pytorch_segmentation_tpu_torch.data import DataLoader, Fetcher, PostFetch
from pytorch_segmentation_tpu_torch.engine import Trainer, test
from pytorch_segmentation_tpu_torch.engine.steps import (create_train_state,
                                                         distill_loss,
                                                         make_train_step)
from pytorch_segmentation_tpu_torch.engine.trainer import make_optimizer
from pytorch_segmentation_tpu_torch.models import make_maskformer_loss
from pytorch_segmentation_tpu_torch.nn.backbones.mobilenetv2 import (
    InvertedResidual)
from pytorch_segmentation_tpu_torch.nn.blocks import (ConvNormAct,
                                                      set_force_fused_1x1)
from pytorch_segmentation_tpu_torch.ops.loss import (build_loss,
                                                     compute_loss,
                                                     lovasz_softmax_loss,
                                                     make_loss_fn)
from pytorch_segmentation_tpu_torch.parallel import (make_mesh,
                                                     put_replicated_tree,
                                                     replicated_sharding,
                                                     shard_batch)
from pytorch_segmentation_tpu_torch.parallel.mesh import (
    batch_statistics_over)
from pytorch_segmentation_tpu_torch.utils.weights import seeded_state_dict

WORLD = 2
NC, HW, WIDTH, BATCH = 3, 16, 8, 4   # BATCH: the global batch
LR, MOMENTUM = 0.1, 0.9
IGNORE = 255
CLASS_WEIGHTS = (1.0, 2.0, 0.5)


class TinyNet(nn.Module):
    """A stride-2 stem and a second ConvNormAct (or, folded=True, an
    InvertedResidual, whose 1x1 convolutions take the fused path with the
    switch on), then a biased 1x1 classifier: logits at stride 2."""

    def __init__(self, folded: bool = False):
        super().__init__()
        self.stem = ConvNormAct(3, WIDTH, 3, stride=2, dtype=torch.float32)
        self.mid = (InvertedResidual(WIDTH, WIDTH, 1, 2, dtype=torch.float32)
                    if folded else
                    ConvNormAct(WIDTH, WIDTH, 3, dtype=torch.float32))
        self.cls = nn.Conv2d(WIDTH, NC, 1)

    def forward(self, x):
        return self.cls(self.mid(self.stem(x)))


def tiny_net(folded=False) -> TinyNet:
    model = TinyNet(folded)
    model.load_state_dict(seeded_state_dict(model, seed=0, init="uniform"))
    return model.to(memory_format=torch.channels_last)


def global_batches(n: int, seed: int, ignored=False):
    """n global batches of normal f32 images and labels in [0, NC). With
    `ignored`, the first sample's lower three quarters and one row of the
    last sample are IGNORE: the two ranks' shards hold uneven valid
    pixels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.standard_normal((BATCH, HW, HW, 3)).astype(np.float32)
        segs = rng.integers(0, NC, (BATCH, HW, HW)).astype(np.int64)
        if ignored:
            segs[0, HW // 4:] = IGNORE
            segs[-1, 3] = IGNORE
        out.append((images, segs))
    return out


def _cpu_state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def run_steps(mesh, kind="plain", accumulate=1, loss_fn=None, n=1,
              ignored=False):
    """`n` calls of `make_train_step` from the seeded start (SGD, lr 0.1,
    momentum 0.9) on the global batches (this rank's shard of each under a
    mesh). Returns the losses and the final state_dict."""
    model = tiny_net(folded=kind == "folded")
    if mesh is not None:
        put_replicated_tree(replicated_sharding(mesh), model)
    optimizer = make_optimizer(model.parameters(), lr=LR, momentum=MOMENTUM)
    state = create_train_state(model, optimizer, accumulate=accumulate)
    step = make_train_step(loss_fn=loss_fn or make_loss_fn(),
                           accumulate=accumulate, mesh=mesh)
    losses = []
    set_force_fused_1x1("on" if kind == "folded" else None)
    try:
        for images, segs in global_batches(n, seed=5, ignored=ignored):
            if mesh is not None:
                images, segs = shard_batch(mesh, images, segs)
            else:
                images, segs = torch.from_numpy(images), torch.from_numpy(segs)
            state, loss = step(state, images, segs)
            losses.append(float(loss))
    finally:
        set_force_fused_1x1(None)
    return {"losses": losses, "state": _cpu_state(model)}


class Batches:
    """A fetcher over fixed global batches: this rank's shard of each."""

    def __init__(self, batches, mesh):
        self.batches, self.mesh = batches, mesh

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for images, segs in self.batches:
            if self.mesh is not None:
                images, segs = shard_batch(self.mesh, images, segs)
            yield images, segs, images.shape[0]


def run_zero(mesh, workdir):
    """`Trainer(zero=True)` with EMA and a clip that bites, one epoch of 3
    steps, then `save`; and the Trainer resumed from that file. Returns the
    epoch's loss, the checkpoint as written and the resumed optimizer's
    state_dict."""
    kw = dict(loss_fn=make_loss_fn(), workdir=workdir, lr=LR,
              momentum=MOMENTUM, weight_decay=1e-3, clip_grad=0.5,
              ema_decay=0.9, log=False, log_dir=workdir, device="cpu",
              mesh=mesh, zero=True)
    batches = global_batches(3, seed=9)
    trainer = Trainer(tiny_net(), Batches(batches, mesh), **kw)
    loss = trainer.step()
    trainer.save()
    if mesh is not None:
        dist.barrier()  # rank 0 has written last.pt
    ckpt = torch.load(os.path.join(workdir, "last.pt"), weights_only=True)
    resumed = Trainer(tiny_net(), Batches(batches, mesh), resume=True, **kw)
    return {"loss": loss, "ckpt": ckpt,
            "resumed": resumed.optimizer.state_dict(),
            "sharded": trainer.zero}


class Records:
    """u8 images and labels in host memory, with class names."""

    def __init__(self, n, seed=3):
        rng = np.random.default_rng(seed)
        self.classes = [f"c{i}" for i in range(NC)]
        self.images = rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
        self.segs = rng.integers(0, NC, (n, HW, HW)).astype(np.uint8)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.segs[i]


def run_eval(mesh, report_path):
    """`test()` of the seeded model over 10 records in global batches of 8:
    5 records a rank, in a batch of 4 and one of 1 padded to 4, or in one
    process a batch of 8 and one of 2 padded to 8 (the same global
    batches)."""
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    loader = DataLoader(Records(10), 8 // world, num_workers=1, rank=rank,
                        world_size=world)
    miou = test(tiny_net().eval(), Fetcher(loader, PostFetch(device="cpu")),
                show_first_batch=False, log=False, mesh=mesh,
                report_path=report_path, device="cpu")
    return {"miou": miou}


def _maskformer_criterion():
    loss_fn = make_maskformer_loss(NC)
    queries = 4

    def criterion(logits, segs):
        # the logits' first NC + 1 channels as 4 queries' class scores and
        # their grid as the queries' masks: any differentiable outputs do
        b = logits.shape[0]
        cls = logits.mean(dim=(1, 2))[:, None, :].expand(b, queries, NC)
        cls = torch.cat([cls, cls[..., :1]], -1)
        mask = logits.permute(0, 3, 1, 2)[:, :1].expand(b, queries, -1, -1)
        return loss_fn({"cls": cls * torch.arange(1.0, queries + 1)[:, None],
                        "mask": mask}, segs)
    return criterion


def loss_functions():
    """name -> loss(logits [B, h, w, NC], segs [B, HW, HW])."""
    kw = dict(class_weights=CLASS_WEIGHTS, ignore_index=IGNORE)
    return {
        "default_ce": make_loss_fn(),
        "ce_ignore_index": lambda x, y: compute_loss(x, y,
                                                     ignore_index=IGNORE),
        "ce_weights_ignore": build_loss("ce", **kw),
        "ce_weights_smoothing": build_loss("ce", label_smoothing=0.1, **kw),
        "dice": build_loss("dice"),
        "ce+dice": build_loss("ce+dice"),
        "focal": build_loss("focal"),
        "ce+rect": build_loss("ce+rect"),
        # a teacher that is a function of each pixel's own logits
        "distillation": lambda x, y: distill_loss(
            x, torch.tanh(x.detach() * 0.5), temp=2.0),
        "maskformer": _maskformer_criterion(),
        "ohem": build_loss("ce", ohem_frac=0.3),
        "lovasz": lambda x, y: lovasz_softmax_loss(
            torch.nn.functional.interpolate(
                x.permute(0, 3, 1, 2), scale_factor=2).permute(0, 2, 3, 1),
            y),
    }


def global_logits():
    rng = np.random.default_rng(21)
    logits = 2.0 * rng.standard_normal((BATCH, HW // 2, HW // 2, NC))
    segs = global_batches(1, seed=22, ignored=True)[0][1]
    segs[1, :2] = 0  # class 0 present where the other rank has little
    return logits.astype(np.float32), segs


def run_losses(mesh):
    """Each loss on this rank's shard (or the global batch) inside
    `batch_statistics_over`: its value and its gradient w.r.t. the logits,
    or the message of what it raised."""
    logits, segs = global_logits()
    if mesh is not None:
        logits, segs = shard_batch(mesh, logits, segs)
    else:
        logits, segs = torch.from_numpy(logits), torch.from_numpy(segs)
    out = {}
    group = None if mesh is None else mesh.group
    for name, fn in loss_functions().items():
        x = logits.clone().requires_grad_(True)
        try:
            with batch_statistics_over(group):
                value = fn(x, segs)
            (grad,) = torch.autograd.grad(value, x)
            out[name] = (float(value.detach()), grad)
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def scenarios(mesh, tmp):
    return {
        "plain": run_steps(mesh),
        "accumulate": run_steps(mesh, accumulate=2, n=4),
        "folded": run_steps(mesh, kind="folded"),
        "weighted_ce": run_steps(
            mesh, loss_fn=build_loss("ce", class_weights=CLASS_WEIGHTS,
                                     ignore_index=IGNORE), ignored=True),
        "zero": run_zero(mesh, os.path.join(tmp, "zero")),
        "eval": run_eval(mesh, os.path.join(tmp, "report.json")),
        "losses": run_losses(mesh),
    }


def rank_main(rank: int, tmp: str) -> None:
    """The body of one spawned rank: the gloo group over a FileStore under
    `tmp`, every scenario, the results in `tmp/rank<r>.pt`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(devices=["cpu"])
        torch.save(scenarios(mesh, tmp), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
