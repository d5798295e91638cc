"""Data parallelism over processes and cards (port of
pytorch_segmentation_tpu/parallel/mesh.py).

The JAX package runs one global program over a device mesh and lets its
partitioner insert the all-reduces. In PyTorch's idiom the same program is
written out:

- Training and evaluation: one process per card, as the reference's DDP
  (its train.py:108-123). The mesh is the default process group: NCCL on the
  card, gloo when the caller asks for the CPU. Each process holds a replica
  of the model and steps on its rank's shard of the global batch; the
  collectives are explicit: the gradients' mean in buckets
  (`all_reduce_mean_`, engine/steps.py), BatchNorm's moments and the loss
  ratios' sums over all ranks (`batch_statistics_over`, `batch_mean`,
  `batch_sum`; nn/blocks.py, ops/loss.py), the eval counts
  (engine/evaluate.py). A step over N ranks computes what one process
  computes on the concatenated global batch, up to rounding.
- Serving: one process over its local cards, as the JAX single-host mesh:
  the model replicated on each card, the batch split into one chunk a card
  (`replicas`, `split_batch`; inference.py).

`initialize_distributed()` sets the process group up from torchrun's
environment; without that environment there is one process.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import threading

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from ..utils.runtime import host_to_device, require_cuda

__all__ = ["Mesh", "DataSharding", "ReplicatedSharding",
           "initialize_distributed", "make_mesh", "data_sharding",
           "replicated_sharding", "shard_batch", "put_global_batch",
           "put_replicated_tree", "replicas", "split_batch",
           "require_one_device", "all_reduce_mean_", "batch_statistics_over",
           "batch_world", "batch_sum", "batch_mean", "require_local_batch"]

# f32 elements in one all-reduce of the gradients' mean (64 MiB)
BUCKET_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class Mesh:
    """group: the process group over which the ranks' batch shards combine
    (None for one process without one); rank / world: this process's place
    in it; devices: this process's cards (one under a process group, every
    local card of a serving process) or the CPU; axis_name: the batch
    axis's name, as in the JAX mesh."""
    group: object
    rank: int
    world: int
    devices: tuple
    axis_name: str = "data"

    @property
    def device(self) -> torch.device:
        return self.devices[0]


@dataclasses.dataclass(frozen=True)
class DataSharding:
    """The batch axis over a mesh: this process holds rows [rank * b,
    (rank + 1) * b) of a global batch of world * b, on `device`."""
    rank: int
    world: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class ReplicatedSharding:
    """Every rank holds the same full value: rank 0's."""
    group: object
    device: torch.device


def initialize_distributed(device=None):
    """`init_process_group` from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): the reference's rendezvous. Binds
    the process to cuda:LOCAL_RANK and takes NCCL, or gloo when `device` is
    the CPU. Without that environment it does nothing and returns None;
    else the process's device."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        device = torch.device("cpu")
    else:
        require_cuda()
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo" if cpu else "nccl", init_method="env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def make_mesh(devices=None, axis_name: str = "data",
              spatial: int = 1) -> Mesh:
    """Under a process group: the group, with this process's one device
    (default: the card it is bound to). Without one: one process over
    `devices` (default: every local card; the CPU only when asked for).
    spatial > 1, the JAX package's (data, space) mesh, is not ported."""
    if spatial > 1:
        from ..utils.cli import ROADMAP_ITEMS
        raise NotImplementedError(f"make_mesh(spatial={spatial}) is not "
                                  f"ported yet ({ROADMAP_ITEMS[10]})")
    if dist.is_initialized():
        if devices is None:
            devices = (require_cuda(),)
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) != 1:
            raise ValueError("a rank of a process group holds one device: "
                             "launch one process per card (torchrun)")
        return Mesh(dist.group.WORLD, dist.get_rank(),
                    dist.get_world_size(), devices, axis_name)
    if devices is None:
        require_cuda()
        devices = range(torch.cuda.device_count())
        devices = tuple(torch.device("cuda", i) for i in devices)
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    return Mesh(None, 0, 1, devices, axis_name)


def require_one_device(mesh: Mesh, what: str) -> torch.device:
    """The device of a mesh whose processes hold one each (training and
    evaluation: one process per card); raises for a serving mesh of
    several local cards."""
    if len(mesh.devices) != 1:
        raise ValueError(f"{what} runs one process per card: launch it "
                         f"under torchrun (a mesh of {len(mesh.devices)} "
                         f"local cards serves only)")
    return mesh.device


def data_sharding(mesh: Mesh) -> DataSharding:
    return DataSharding(mesh.rank, mesh.world,
                        require_one_device(mesh, "a sharded batch"))


def replicated_sharding(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh.group,
                              require_one_device(mesh, "a replicated tree"))


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of GLOBAL batches (numpy arrays or tensors whose
    first axis divides by the world size), on the mesh's device."""
    device = require_one_device(mesh, "shard_batch")
    out = []
    for a in arrays:
        n = a.shape[0]
        if n % mesh.world:
            raise ValueError(f"global batch {n} must be divisible by the "
                             f"mesh's {mesh.world} ranks")
        b = n // mesh.world
        out.append(host_to_device(a[mesh.rank * b:(mesh.rank + 1) * b],
                                  device))
    return out[0] if len(out) == 1 else tuple(out)


def put_global_batch(sharding: DataSharding, *arrays):
    """This process's LOCAL batch (its loader's rank shard, the
    DistributedSampler contract) on its device; a tensor already there
    passes through untouched."""
    out = tuple(host_to_device(a, sharding.device) for a in arrays)
    return out[0] if len(out) == 1 else out


def put_replicated_tree(sharding: ReplicatedSharding, tree):
    """Rank 0's values in every rank's copy of `tree` (a module: its
    parameters and buffers; a state_dict or a list of tensors), in place, on
    the sharding's device. Returns the tree."""
    if isinstance(tree, torch.nn.Module):
        tree.to(sharding.device)
        tensors = list(tree.state_dict().values())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    if sharding.group is not None:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, 0, group=sharding.group)
    return tree


def replicas(mesh: Mesh, module: torch.nn.Module) -> list:
    """The serving mesh's replicas of an eval-mode `module`, one per local
    card: the module itself on the first card, copies on the others."""
    at = next(module.parameters()).device
    if (at.type, at.index or 0) != (mesh.device.type, mesh.device.index or 0):
        raise ValueError(f"the model is on {at}, the mesh's first device is "
                         f"{mesh.device}")
    return [module] + [copy.deepcopy(module).to(d) for d in mesh.devices[1:]]


def split_batch(mesh: Mesh, x):
    """A serving batch (numpy or tensor) in one equal chunk per local card;
    raises a ValueError when its size does not divide."""
    n = len(mesh.devices)
    if x.shape[0] % n:
        raise ValueError(f"serving batch {x.shape[0]} must be divisible by "
                         f"the mesh's {n} cards: pad the batch (MaskServer "
                         f"does)")
    if isinstance(x, np.ndarray):
        return np.split(x, n)
    return list(torch.chunk(x, n))


def all_reduce_mean_(tensors, group, world: int) -> None:
    """Each tensor replaced, in place, by its mean over the group's ranks,
    in buckets of up to BUCKET_ELEMENTS elements of one dtype (one
    collective per bucket)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        bucket, size = [], 0
        for t in same + [None]:
            if bucket and (t is None or size + t.numel() > BUCKET_ELEMENTS):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, group=group)
                flat.div_(world)
                for b, part in zip(bucket, flat.split(
                        [b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += t.numel()


_batch = threading.local()


@contextlib.contextmanager
def batch_statistics_over(group):
    """Inside the block, on this thread: train-mode BatchNorm statistics and
    the losses' batch sums are taken over `group`'s ranks (None: this
    process's batch alone), through all-reduces that autograd sees, so the
    backward carries their gradients across ranks."""
    prev = getattr(_batch, "group", None)
    _batch.group = group
    try:
        yield
    finally:
        _batch.group = prev


def batch_world() -> int:
    """The ranks the current batch statistics span (1 outside a mesh)."""
    group = getattr(_batch, "group", None)
    return 1 if group is None else dist.get_world_size(group)


def batch_sum(*values):
    """Each tensor summed over the ranks of `batch_statistics_over` (one
    all-reduce for all of them, in f32); the tensors themselves outside."""
    group = getattr(_batch, "group", None)
    if group is None:
        return values
    flat = torch.cat([v.float().reshape(-1) for v in values])
    flat = dist_nn.all_reduce(flat, group=group)
    parts = flat.split([v.numel() for v in values])
    return tuple(p.view(v.shape) for p, v in zip(parts, values))


def batch_mean(*values):
    """`batch_sum` over the ranks' count: the mean of per-rank means over
    equal shards (the JAX package's `pmean`)."""
    group = getattr(_batch, "group", None)
    if group is None:
        return values
    world = dist.get_world_size(group)
    return tuple(v / world for v in batch_sum(*values))


def require_local_batch(what: str) -> None:
    """Raise for a loss that needs the whole global batch at once (a sort or
    a k-th value over every pixel) when the batch spans several ranks."""
    if batch_world() > 1:
        from ..utils.cli import ROADMAP_ITEMS
        raise NotImplementedError(f"{what} over a batch split across ranks "
                                  f"is not ported yet ({ROADMAP_ITEMS[10]})")
