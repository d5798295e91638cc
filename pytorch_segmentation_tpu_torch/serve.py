"""Serving daemon on the card: batched HTTP mask serving through the port.

    python -m pytorch_segmentation_tpu_torch.serve --weights model.pt \\
        -s 513 513 -nc 21 --port 8500 --max-batch 8
    curl -s -X POST --data-binary @img.png localhost:8500/predict > mask.png
    curl -s localhost:8500/healthz

--weights is required: a `{'model': state_dict}` `.pt` file, such as
`port_weights.py --reverse` writes from a JAX checkpoint (`--ema` serves its
`'ema'` entry). `--tta` and `--tta-scales 0.75 1.25` add flip and
multi-scale test-time augmentation. Requests are PNG images. `--model`
takes every family but maskformer (unet, bisenetv2, danet, deeplabv3,
deeplabv3plus, fastfcn, fcn, fpn, hrnet, lraspp, ocrnet, pspnet,
segformer, segmenter, segnext, upernet), deeplabv3plus the default;
`--variant` a family's size variant (fpn: r50, r34; fcn, deeplabv3,
danet: r50, r101; ocrnet: w18, w32, w48; segnext: tiny, t, s, b;
segformer: b0..b5, tiny, tiny-d4; segmenter: pico, b16, l16; upernet: r50,
r34, mit-b0..mit-b5, mit-tiny, cn-*, swin-*, vit-*), which must
match the checkpoint. A checkpoint of `train --aux-loss` loads without its
train-only auxiliary heads. `--int8`, `--moe`, `--moe-top-k`,
`--scan-blocks` and `--dp` (the root CLI's) exit with status 2 and name
their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os

import torch

from .engine.checkpoint import load_model_bundle
from .models import MODEL_REGISTRY, build_model, variant_kwargs
from .serving import MaskServer
from .utils.cli import refuse_unported

__all__ = ["UNPORTED", "parse_args", "build_server", "main"]

# name -> (default, ROADMAP queue 1 item)
UNPORTED = {"int8": (False, 9), "scan_blocks": (False, 6), "moe": (0, 10),
            "moe_top_k": (2, 10), "dp": (False, 10)}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="deeplabv3plus",
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("-s", "--img_size", type=int, nargs=2,
                        default=[513, 513], metavar=("W", "H"))
    parser.add_argument("-nc", "--num-classes", type=int, default=21)
    parser.add_argument("--weights", type=str, required=True,
                        help="a {'model': state_dict} .pt checkpoint")
    parser.add_argument("--variant", type=str, default="",
                        help="model size variant (fpn: r50/r34; fcn, "
                             "deeplabv3, danet: r50/r101; ocrnet: "
                             "w18/w32/w48; segnext: tiny/t/s/b; segformer: "
                             "b0..b5; upernet: r50/r34/mit-b0..b5/cn-*/"
                             "swin-*/vit-*); must match the checkpoint")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--max-batch", type=int, default=8,
                        help="static device batch (requests pad to it; "
                             "bigger = more throughput, more latency)")
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="how long to wait coalescing concurrent "
                             "requests into one batch")
    parser.add_argument("--legacy-preproc", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="int8 PTQ forward (not ported yet)")
    parser.add_argument("--ema", action="store_true",
                        help="serve the EMA-averaged weights")
    parser.add_argument("--tta", action="store_true",
                        help="flip TTA (~2x cost per request)")
    parser.add_argument("--tta-scales", type=float, nargs="+", default=[],
                        metavar="S", help="multi-scale TTA")
    parser.add_argument("--moe", type=int, default=0, metavar="E",
                        help="mixture-of-experts FFNs (not ported yet)")
    parser.add_argument("--moe-top-k", type=int, default=2, metavar="K")
    parser.add_argument("--scan-blocks", action="store_true",
                        help="a stacked-params checkpoint (not ported yet)")
    parser.add_argument("--dp", action="store_true",
                        help="data-parallel serving (not ported yet)")
    opt = parser.parse_args(argv)
    refuse_unported(parser, opt, UNPORTED)
    if not os.path.isfile(opt.weights):
        parser.error(f"--weights {opt.weights!r} is not a file")
    return opt


def build_server(opt: argparse.Namespace, device) -> MaskServer:
    """The model the options name, with the checkpoint's weights (its EMA
    parameters with --ema) on `device`, behind a MaskServer with the
    options' batching, preprocessing and TTA. Not started."""
    model = build_model(opt.model, num_classes=opt.num_classes,
                        dtype=torch.bfloat16, full_res_output=False,
                        **variant_kwargs(opt.model, opt.variant))
    model = load_model_bundle(model, opt.weights, device, use_ema=opt.ema)
    return MaskServer(model, img_size=tuple(opt.img_size),
                      max_batch=opt.max_batch,
                      batch_window_ms=opt.batch_window_ms,
                      legacy_preproc=opt.legacy_preproc, tta_flip=opt.tta,
                      tta_scales=tuple(opt.tta_scales))


def main(argv=None):
    opt = parse_args(argv)

    from .utils.runtime import require_cuda

    device = require_cuda()
    server = build_server(opt, device)
    host, port = server.start(opt.host, opt.port)[:2]
    print(f"serving {opt.model} ({opt.num_classes} classes, "
          f"{opt.img_size[0]}x{opt.img_size[1]}) on "
          f"{torch.cuda.get_device_name(device)} at http://{host}:{port} "
          f"— POST /predict, GET /healthz", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
