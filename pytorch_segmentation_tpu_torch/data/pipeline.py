"""Device-side batch pipeline: augmentation hook, normalization and
multi-scale resize (port of pytorch_segmentation_tpu/data/pipeline.py).

`PostFetch` is what a `Fetcher` applies to each host `Batch`: the u8 batch is
copied to the device, augmented there (`data/augment.py`), normalized, and
optionally resized to a size drawn on the host. The randomness of batch `k`
is a function of `(seed, k)` only, so a resumed run can redraw any batch.

Multi-scale: one of the sizes of `multi_scale_sizes(base_hw)` (a random
0.7-1.5 scale of the base size snapped to multiples of 32) is picked per
batch on the host, and the normalized batch is resized with nearest
interpolation, as `F.interpolate` does by default.
"""

from __future__ import annotations

import contextlib
import random as _pyrandom

import torch

from ..ops.resize import resize_nearest
from ..utils.runtime import device_constant, require_cuda
from .datasets import IMAGENET_MEAN, IMAGENET_STD
from .loader import Batch
from .resize_host import multi_scale_sizes

__all__ = ["normalize_images", "PostFetch", "multi_scale_sizes"]


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 RGB NHWC -> ImageNet-normalized float NHWC, computed in f32 on
    the images' device."""
    mean = device_constant(tuple(IMAGENET_MEAN.tolist()), images.device)
    std = device_constant(tuple(IMAGENET_STD.tolist()), images.device)
    x = images.to(torch.float32)
    return ((x - mean) / std).to(dtype)


def _batch_seed(seed: int, step: int, stream: int = 0) -> int:
    """A 63-bit generator seed from (seed, batch counter, stream id) by the
    splitmix64 finalizer: distinct triples give unrelated generators."""
    z = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
         + stream * 0x94D049BB133111EB + 0x2545F4914F6CDD1D) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & (2 ** 63 - 1)


class PostFetch:
    """Callable applied to each host Batch; returns tensors on `device`
    (images normalized `dtype`, segs int32) and the batch's valid count.

    `device` is explicit: None means the first CUDA device and raises when
    there is none; the CPU is used only when asked for. The work runs under
    `torch.no_grad()` on the device's current stream, whichever thread calls
    (a `Fetcher` calls from its producer thread).

    Not ported yet: `mix_fn` (ROADMAP: Losses and extras, data/mix.py) and
    `sharding` (ROADMAP: parallel/)."""

    def __init__(self, augment_fn=None, multi_scale: bool = False,
                 base_hw=None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, sharding=None,
                 mix_fn=None, device=None):
        if mix_fn is not None:
            raise NotImplementedError(
                "PostFetch(mix_fn=...) is not ported yet (ROADMAP: Losses "
                "and extras, data/mix.py)")
        if sharding is not None:
            raise NotImplementedError(
                "PostFetch(sharding=...) is not ported yet (ROADMAP: "
                "parallel/)")
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.augment_fn = augment_fn
        self.multi_scale = multi_scale
        self.base_hw = base_hw
        self.dtype = dtype
        self.seed = int(seed)
        self._rng = _pyrandom.Random(seed)
        self._step = 0

    def _to_device(self, array) -> torch.Tensor:
        """The host array on the device. For the card it goes through
        pinned memory and an asynchronous copy: a copy from pageable memory
        would hold the calling thread until all the work queued on the
        stream is done, the consumer's train step included."""
        tensor = torch.as_tensor(array)
        if self.device.type != "cuda" or tensor.device.type != "cpu":
            return tensor.to(self.device)
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def generators(self, step: int):
        """The device and the host generator of batch `step`."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_batch_seed(self.seed, step, 0))
        host_gen = torch.Generator()
        host_gen.manual_seed(_batch_seed(self.seed, step, 1))
        return gen, host_gen

    @torch.no_grad()
    def __call__(self, batch: Batch):
        # the calling thread (a Fetcher's producer) works on this device
        on_device = (torch.cuda.device(self.device)
                     if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with on_device:
            return self._run(batch)

    def _run(self, batch: Batch):
        out_hw = None
        if self.multi_scale and self.base_hw is not None:
            out_hw = self._rng.choice(multi_scale_sizes(self.base_hw))
        step = self._step
        self._step += 1
        images = self._to_device(batch.images)
        segs = self._to_device(batch.segs)
        if self.augment_fn is not None:
            gen, host_gen = self.generators(step)
            images, segs = self.augment_fn(gen, images, segs,
                                           host_gen=host_gen)
        images = normalize_images(images, dtype=self.dtype)
        segs = segs.to(torch.int32)
        if out_hw is not None:
            images = resize_nearest(images, out_hw)
        return images, segs, batch.valid
