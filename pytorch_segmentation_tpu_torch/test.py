"""Evaluation CLI of the port (port of the root test.py).

    python -m pytorch_segmentation_tpu_torch.test data/coco/val.json \\
        --model deeplabv3plus --weights weights/best.pt -s 513 513 -bs 32

The same flags, names and defaults as the root CLI: the val set (`coco`
JSON, or a `segimg` / `idimg` list file; PNG images) through the port's
`load_model_bundle` and `engine.test`, with `--ema`, `--tta`,
`--tta-scales`, `--tile`, `--tile-overlap`, `--boundary-iou`, `--report`
and `--ignore-index`. Prints the per-class table and `metrics: <mIoU>`.
`--model` takes every family (unet, bisenetv2, danet, deeplabv3,
deeplabv3plus, fastfcn, fcn, fpn, hrnet, lraspp, maskformer, ocrnet,
pspnet, segformer, segmenter, segnext, upernet) and `--variant` a family's
size variant (fpn: r50, r34; fcn, deeplabv3, danet: r50, r101; ocrnet:
w18, w32, w48; segnext: tiny, t, s, b; segformer: b0..b5, tiny, tiny-d4;
segmenter: pico, b16, l16; maskformer: r50, tiny; upernet: r50, r34,
mit-b0..mit-b5, mit-tiny, cn-*, swin-*, vit-*); `--scan-blocks` builds
segformer's stacked block stages (a checkpoint of `train --scan-blocks`;
another family exits with status 2); a checkpoint of `train --aux-loss`
loads without its train-only auxiliary heads (BiSeNetV2's booster heads
too). `--int8` evaluates the int8 forward (`quant.py`) with dynamic
activation scales; `--int8 --calib-batches N` calibrates the scales on the
first N normalized val batches first and evaluates the calibrated forward.
`--moe` exits with status 2 and names its ROADMAP item. Runs on the card;
`run(opt, "cpu")` runs the same on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from .data import (CocoDataset, DataLoader, Fetcher, IdImgDataset, PostFetch,
                   SegImgDataset)
from .engine import test
from .engine.checkpoint import load_model_bundle
from .models import (MODEL_REGISTRY, apply_scan_blocks, build_model,
                     variant_kwargs, without_default_init)
from .quant import calibrate
from .utils.cli import refuse_unported
from .utils.runtime import require_cuda

__all__ = ["DATASETS", "UNPORTED", "run", "build_parser", "parse_args",
           "main"]

DATASETS = {"coco": CocoDataset, "segimg": SegImgDataset,
            "idimg": IdImgDataset}

# name -> (default, ROADMAP queue 1 item)
UNPORTED = {"moe": (0, 10)}


def run(opt: argparse.Namespace, device=None) -> float:
    """Evaluate as the root CLI does, on `device` (None: the card); returns
    the mIoU."""
    device = require_cuda() if device is None else torch.device(device)
    val_data = DATASETS[opt.dataset](opt.val, img_size=opt.img_size,
                                     augments=False, rect=opt.rect,
                                     cache_images=opt.cache_images)
    val_loader = DataLoader(val_data, batch_size=opt.batch_size,
                            num_workers=opt.num_workers)
    val_fetcher = Fetcher(val_loader, PostFetch(device=device))
    with without_default_init():
        model = build_model(opt.model, num_classes=len(val_data.classes),
                            **apply_scan_blocks(
                                opt.model,
                                variant_kwargs(opt.model, opt.variant),
                                opt.scan_blocks))
    model = load_model_bundle(model, opt.weights, device, use_ema=opt.ema)
    quant_stats = None
    if opt.int8 and opt.calib_batches > 0:
        # the fetcher's batches are normalized already
        calib = []
        for i, (images, _, _) in enumerate(val_fetcher):
            if i >= opt.calib_batches:
                break
            calib.append(images)
        quant_stats = calibrate(model, calib)
        print(f"calibrated int8 scales on {len(calib)} val batches")
    return test(model, val_fetcher, int8=opt.int8, quant_stats=quant_stats,
                tta_flip=opt.tta,
                tta_scales=opt.tta_scales, report_path=opt.report or None,
                ignore_index=opt.ignore_index,
                tile=(opt.tile[1], opt.tile[0]) if opt.tile else None,
                tile_overlap=opt.tile_overlap,
                boundary_ratio=opt.boundary_iou, device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("val", type=str,
                   help="val.json (coco) or val.txt (segimg/idimg)")
    p.add_argument("--ignore-index", type=int, default=None, metavar="ID",
                   help="label id excluded from the loss and the counts")
    p.add_argument("--dataset", type=str, default="coco",
                   choices=sorted(DATASETS))
    p.add_argument("--model", type=str, default="deeplabv3plus",
                   choices=sorted(MODEL_REGISTRY))
    p.add_argument("--weights", type=str, default="",
                   help="a .pt checkpoint; empty: weights made from seed 0")
    p.add_argument("--variant", type=str, default="")
    p.add_argument("--moe", type=int, default=0, metavar="E")
    p.add_argument("--moe-top-k", type=int, default=2, metavar="K")
    p.add_argument("--rect", action="store_true")
    p.add_argument("-s", "--img_size", type=int, nargs=2, default=[320, 320])
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--int8", action="store_true",
                   help="evaluate the int8 forward")
    p.add_argument("--calib-batches", type=int, default=0,
                   help="with --int8: calibrate the activation scales on "
                        "this many val batches first; 0: dynamic scales")
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA-averaged weights of train --ema")
    p.add_argument("--tta", action="store_true",
                   help="flip test-time augmentation (~2x eval cost)")
    p.add_argument("--scan-blocks", action="store_true")
    p.add_argument("--cache-images", action="store_true")
    p.add_argument("--report", type=str, default="", metavar="FILE",
                   help="write the full per-class table as JSON")
    p.add_argument("--tile", type=int, nargs=2, default=None,
                   metavar=("W", "H"),
                   help="sliding-window evaluation with WxH windows")
    p.add_argument("--boundary-iou", type=float, nargs="?", const=0.02,
                   default=None, metavar="R",
                   help="also report Boundary IoU (band ratio R)")
    p.add_argument("--tile-overlap", type=float, default=1 / 3)
    p.add_argument("--tta-scales", type=float, nargs="+", default=[],
                   metavar="S", help="multi-scale TTA, e.g. 0.75 1.0 1.25")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    opt = parser.parse_args(argv)
    refuse_unported(parser, opt, UNPORTED)
    return opt


def main(argv=None, device=None) -> float:
    """Parse `argv` and evaluate on `device` (None: the card); prints and
    returns the mIoU."""
    metrics = run(parse_args(argv), device)
    print("metrics: %8g" % metrics)
    return metrics


if __name__ == "__main__":
    main()
