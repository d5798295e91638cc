"""ZeRO-1 optimizer-state sharding (port of
pytorch_segmentation_tpu/parallel/zero.py).

Data parallelism replicates the optimizer state on every rank, as the
reference's DDP replicates everything. None of the f32 per-parameter trees
needs to be: the momentum or Adam moments, the gradient accumulator of
`accumulate > 1` and the EMA average are each only ever read where they are
updated. Under ZeRO stage 1 (Rajbhandari et al. 2020) each rank keeps the
shard of each leaf that it owns, on the leaf's largest dimension that
divides by the rank count (`zero_leaf_spec`, the JAX rule; a leaf with no
such dimension stays replicated). Each step the averaged gradients are
sliced to the owned shards (the train step all-reduces them, which gloo
carries too, where it lacks a reduce-scatter), every rank updates its shards
with the same optimizer arithmetic, and the updated parameters are
all-gathered back into every replica. The trajectory is the replicated one:
the update is elementwise, and only the clip's global norm sums in another
order.

Composition: with one rank ZeRO is the replicated path (the JAX Trainer's
rule); it composes with data parallelism only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["zero_leaf_spec", "ZeroOptimizer"]


def zero_leaf_spec(leaf, n: int, axis: str = "data") -> tuple:
    """The JAX function's PartitionSpec as a tuple: `axis` at `leaf`'s
    largest n-divisible dimension, None elsewhere; () (replicated) when no
    dimension divides (scalars, tiny leaves)."""
    shape = tuple(getattr(leaf, "shape", ()))
    best_dim, best_size = None, 0
    for d, s in enumerate(shape):
        if s % n == 0 and s > best_size:
            best_dim, best_size = d, s
    if best_dim is None:
        return ()
    spec = [None] * len(shape)
    spec[best_dim] = axis
    return tuple(spec)


def _shard_dim(leaf, n: int):
    spec = zero_leaf_spec(leaf, n)
    return spec.index("data") if spec else None


class ZeroOptimizer:
    """An optimizer over the mesh rank's shards of `params` (full-size
    parameters, replicated on every rank). `make_inner(shards)` builds the
    optimizer chain that updates the shards (engine.trainer.make_optimizer,
    without its clip: the clip's norm here is global). Same interface as
    `OptimizerChain`: `apply(count)` consumes the shards' `.grad` (the
    train step sets them from `shard(grads)`), then `gather()` writes the
    updated shards into every rank's full parameters. `state_dict()` is the
    gathered full state, the same as a replicated optimizer's, so a
    checkpoint does not depend on the rank count; it and `gather` are
    collectives that every rank calls."""

    def __init__(self, params, mesh, make_inner, clip_grad: float = 0.0):
        self.full = list(params)
        self.group, self.rank, self.world = mesh.group, mesh.rank, mesh.world
        self.dims = [_shard_dim(p, self.world) for p in self.full]
        # views of the full parameters: the update writes this rank's slice
        # in place, and `gather` fills in the others'
        self.params = self.shard([p.detach() for p in self.full])
        self.inner = make_inner(self.params)
        self.schedule = self.inner.schedule
        self.clip_grad = float(clip_grad)

    def shard(self, tensors) -> list:
        """This rank's shard of each full-size tensor (views), in the order
        of the parameters."""
        return [t if d is None else t.chunk(self.world, d)[self.rank]
                for t, d in zip(tensors, self.dims)]

    @torch.no_grad()
    def apply(self, count: int) -> None:
        if self.clip_grad:
            # optax.clip_by_global_norm over the FULL gradient: the owned
            # shards' squares summed over ranks, a replicated leaf's once
            grads = [p.grad for p in self.params]
            sq = [g.float().square().sum() for g in grads]
            sharded = torch.stack([s for s, d in zip(sq, self.dims)
                                   if d is not None] or [sq[0] * 0])
            total = sharded.sum()
            dist.all_reduce(total, group=self.group)
            for s, d in zip(sq, self.dims):
                if d is None:
                    total = total + s
            norm = total.sqrt()
            scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                self.clip_grad / norm)
            torch._foreach_mul_(grads, scale)
        self.inner.apply(count)

    @torch.no_grad()
    def gather_tensors(self, shards) -> list:
        """Full-size tensors from every rank's shards (one all-gather);
        a replicated leaf's value as it is."""
        idx = [i for i, d in enumerate(self.dims) if d is not None]
        if not idx:
            return list(shards)
        pieces = self._all_gather([shards[i] for i in idx])
        out = list(shards)
        for j, i in enumerate(idx):
            out[i] = torch.cat([pieces[r][j].view_as(shards[i])
                                for r in range(self.world)], self.dims[i])
        return out

    @torch.no_grad()
    def gather(self) -> None:
        """The other ranks' updated shards into this rank's full parameters
        (one all-gather; its own shard was updated in place)."""
        idx = [i for i, d in enumerate(self.dims) if d is not None]
        if not idx:
            return
        parts = self._all_gather([self.params[i] for i in idx])
        for r, pieces in enumerate(parts):
            if r == self.rank:
                continue
            for i, piece in zip(idx, pieces):
                self.full[i].detach().chunk(self.world, self.dims[i])[
                    r].copy_(piece.view_as(self.params[i]))

    def _all_gather(self, shards) -> list:
        """Every rank's `shards` (same shapes on every rank), one flat
        all-gather: [rank][shard] flat pieces."""
        flat = torch.cat([s.reshape(-1) for s in shards])
        parts = [torch.empty_like(flat) for _ in range(self.world)]
        dist.all_gather(parts, flat, group=self.group)
        sizes = [s.numel() for s in shards]
        return [p.split(sizes) for p in parts]

    def state_tensors(self) -> list:
        """This rank's shards of the optimizer state, as
        `OptimizerChain.state_tensors` gives them (no collective)."""
        return self.inner.state_tensors()

    def state_dict(self) -> dict:
        state = self.inner.state_dict()
        entries = {i: dict(e) for i, e in state["state"].items()}
        names = sorted({k for e in entries.values() for k, v in e.items()
                        if isinstance(v, torch.Tensor) and v.dim()})
        for name in names:   # every rank holds the same names
            full = self.gather_tensors(
                [entries.get(i, {}).get(name, p)
                 for i, p in enumerate(self.params)])
            for i, e in entries.items():
                if name in e:
                    e[name] = full[i]
        return {**state, "state": entries}

    def load_state_dict(self, state: dict) -> None:
        """A full (replicated or gathered) optimizer state, sliced to this
        rank's shards."""
        entries = {
            i: {k: (v.chunk(self.world, self.dims[i])[self.rank].clone()
                    if isinstance(v, torch.Tensor) and v.dim()
                    and self.dims[i] is not None else v)
                for k, v in e.items()}
            for i, e in state["state"].items()}
        self.inner.load_state_dict({**state, "state": entries})
