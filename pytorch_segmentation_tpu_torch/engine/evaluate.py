"""Evaluation engine (port of pytorch_segmentation_tpu/engine/evaluate.py).

Streams batches through the eval step, which returns the loss and the
per-class tp/fn/fp vectors as tensors on the model's device with no host
sync. Each batch's results are packed into one small tensor and copied to
pinned host memory asynchronously; the host reads them one batch late, while
the next batch runs, and sums them in float64. Under a mesh each rank
evaluates its shard of the validation set, and each batch's results are
summed over the ranks before the copy.
"""

from __future__ import annotations

import copy
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.boundary import boundary_iou
from ..ops.metrics import compute_metrics, sample_valid_mask
from ..ops.tta import normalize_tta_scales
from ..parallel.mesh import data_sharding, make_mesh, require_one_device
from ..utils.runtime import require_cuda, same_device
from ..utils.visualize import show_batch
from .steps import make_eval_step, make_predict_step

__all__ = ["test"]


class _Pending:
    """One batch's results on their way to the host: the step's tensors
    packed into one f32 vector, copied without blocking (through pinned
    memory and an event on the card)."""

    def __init__(self, results):
        packed = torch.cat([r.reshape(-1).float() for r in results])
        self.event = None
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed

    def read(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().astype(np.float64)


def test(model: torch.nn.Module, fetcher, show_first_batch: bool = True,
         log: bool = True, mesh=None, int8: bool = False, quant_stats=None,
         tta_flip: bool = False, tta_scales=(),
         report_path: str | None = None, ignore_index: int | None = None,
         tile=None, tile_overlap: float = 1 / 3,
         boundary_ratio: float | None = None, device=None) -> float:
    """model: an eval-mode module on `device` (`Trainer.model`,
    `Trainer.ema_model`, `load_model_bundle`); fetcher: yields `(images,
    segs, valid)` per batch and exposes `.loader.dataset.classes`. Returns
    the mean IoU (float).

    `device` is explicit: None means the first CUDA device and raises when
    there is none; the CPU is used only when asked for. The model must
    already be there: nothing is moved silently. Batches are copied to the
    device when the fetcher left them elsewhere.

    Prints the per-class table (or the 5 worst classes when there are 10 or
    more). A `full_res_output` model is evaluated through its stride-4 twin,
    with the upsample folded into the eval step (the same predictions: the
    deferred resize is the model's trailing one), which on the card runs the
    fused upsample+CE and upsample+argmax+confusion kernels.

    tta_flip=True averages logits with a horizontally-flipped second
    forward; tta_scales adds multi-scale TTA (ops/tta.py), composing with
    the flip. report_path writes the FULL per-class table plus the raw
    confusion sums as JSON. ignore_index excludes those pixels from the loss
    and the counts. tile=(H, W) evaluates in mmseg "slide" mode with overlap
    fraction tile_overlap (see steps.make_eval_step). boundary_ratio
    additionally accumulates per-class Boundary IoU (ops/boundary.py; band
    width as a fraction of the image diagonal, official default 0.02),
    printed as a mean and per class in the report.

    int8=True evaluates the int8 forward (quant.py), the mIoU a quantized
    serving deployment gets: dynamic activation scales, or the calibrated
    ones when `quant_stats` (from quant.calibrate, which implies int8) is
    passed. The first batch's picture stays the plain forward's, as in the
    JAX package.

    mesh (`parallel.make_mesh()`; by default the process group when one is
    initialized): one process per card, each evaluating its rank's shard of
    the set (`DataLoader(rank=, world_size=)`; the fetcher's PostFetch gets
    the mesh's `data_sharding`). Each rank masks its own padded samples with
    its `valid`; the counts and the loss sums of each batch are summed over
    the ranks, so every rank returns the global mIoU. The printed table and
    the report come from rank 0; the first-batch picture is skipped across
    processes, as in the JAX package. Every rank calls `test`."""
    if quant_stats is not None:
        int8 = True
    if mesh is None and dist.is_initialized():
        mesh = make_mesh(None if device is None else (device,))
    group = None
    if mesh is not None:
        at = require_one_device(mesh, "test()")
        if device is not None and not same_device(device, at):
            raise ValueError(f"test()'s device {device} is not its mesh's "
                             f"{at}")
        device, group = at, mesh.group
        log = log and mesh.rank == 0
        show_first_batch = show_first_batch and mesh.world == 1
        if mesh.rank != 0:
            report_path = None
        pf = getattr(fetcher, "post_fetch_fn", None)
        if pf is not None and getattr(pf, "sharding", False) is None:
            pf.sharding = data_sharding(mesh)
    device = require_cuda() if device is None else torch.device(device)
    at = next(model.parameters()).device
    if not same_device(at, device):
        raise ValueError(f"the model is on {at}, the evaluation on {device}")
    tta_scales = normalize_tta_scales(tta_scales)
    classes = fetcher.loader.dataset.classes
    num_classes = len(classes)
    # evaluate on low-res logits and resize once in the eval step. The twin
    # shares every parameter and buffer with `model`.
    module = model.eval()
    align = getattr(module, "up_align_corners", True)
    if getattr(module, "full_res_output", None) is True:
        module = copy.copy(module)
        module.full_res_output = False
    eval_step = make_eval_step(num_classes, align_corners=align,
                               quant=int8, tta_flip=tta_flip,
                               tta_scales=tta_scales,
                               ignore_index=ignore_index, tile=tile,
                               tile_overlap=tile_overlap,
                               boundary_ratio=boundary_ratio)

    # rows: tp, fn, fp, boundary intersection, boundary union
    sums = np.zeros((5, num_classes))
    tp, fn, fp, b_int, b_uni = sums
    val_loss = 0.0
    n_read = 0

    def drain(pending):
        nonlocal val_loss, n_read
        got = pending.read()
        if group is not None:  # the ranks' loss sum over their count
            got = np.concatenate([[got[0] / max(got[1], 1.0)], got[2:]])
        val_loss += got[0]
        rows = got[1:].reshape(-1, num_classes)
        sums[:len(rows)] += rows
        n_read += 1

    pending = None  # results of the PREVIOUS batch
    last_print = 0.0
    for n_batches, (images, segs, valid) in enumerate(fetcher, start=1):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        segs = torch.as_tensor(segs).to(device, non_blocking=True)
        res = eval_step(module, images, segs, valid, quant_stats)
        if group is not None:
            n = sample_valid_mask(valid, images.shape[0], device).float().sum()
            packed = torch.cat([r.reshape(-1).float()
                                for r in (res[0] * n, n, *res[1:])])
            dist.all_reduce(packed, group=group)
            res = (packed,)
        if n_batches == 1 and show_first_batch:
            # predictions are needed only for the first batch's picture;
            # computed separately on <= 8 samples
            pred = make_predict_step(align_corners=align)(
                module, images[:8], segs.shape[1:3])
            show_batch(images[:8], pred)
        res = _Pending(res)
        # read one batch late: the host then waits for results the card has
        # already finished, while this batch runs
        if pending is not None:
            drain(pending)
        pending = res
        if log and n_read and time.monotonic() - last_print >= 1.0:
            last_print = time.monotonic()
            _, P, _, miou, F1 = compute_metrics(tp, fn, fp)
            print("%d/%d loss: %8g, mAP: %8g, F1: %8g, miou: %8g"
                  % (n_batches, len(fetcher), val_loss / n_read, P.mean(),
                     F1.mean(), miou.mean()))
    if pending is not None:
        drain(pending)

    T, P, R, miou, F1 = compute_metrics(tp, fn, fp)
    biou = None
    if boundary_ratio is not None:
        biou = boundary_iou(b_int, b_uni).numpy()
    if report_path:
        report = {
            "miou": float(miou.mean()),
            "val_loss": val_loss / max(1, n_read),
            "num_classes": num_classes,
            "per_class": [
                {"name": str(c), "targets": int(T[ci]),
                 "precision": float(P[ci]), "recall": float(R[ci]),
                 "iou": float(miou[ci]), "f1": float(F1[ci]),
                 "tp": float(tp[ci]), "fn": float(fn[ci]),
                 "fp": float(fp[ci]),
                 **({"boundary_iou": float(biou[ci])}
                    if biou is not None else {})}
                for ci, c in enumerate(classes)],
        }
        if biou is not None:
            report["mean_boundary_iou"] = float(biou.mean())
            report["boundary_ratio"] = boundary_ratio
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
    if log:
        if num_classes < 10:
            order = range(num_classes)
        else:
            print("top error 5")
            order = np.argsort(miou)[:5]
        for ci in order:
            print("cls: %8s, targets: %8d, pre: %8g, rec: %8g, "
                  "iou: %8g, F1: %8g"
                  % (classes[ci], T[ci], P[ci], R[ci], miou[ci], F1[ci]))
        if biou is not None:
            print("mean boundary iou (band %g of diagonal): %8g"
                  % (boundary_ratio, biou.mean()))
    return float(miou.mean())


# keep pytest from collecting the `test` entry point
test.__test__ = False
