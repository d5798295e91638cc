"""Serving daemon on the card: batched HTTP mask serving through the port.

    python -m pytorch_segmentation_tpu_torch.serve --weights model.pt \\
        -s 513 513 -nc 21 --port 8500 --max-batch 8
    curl -s -X POST --data-binary @img.png localhost:8500/predict > mask.png
    curl -s localhost:8500/healthz

--weights is required: a `{'model': state_dict}` `.pt` file, such as
`port_weights.py --reverse` writes from a JAX checkpoint. Requests are PNG
images.
"""

from __future__ import annotations

import argparse
import os

from .models import MODEL_REGISTRY


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="deeplabv3plus",
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("-s", "--img_size", type=int, nargs=2,
                        default=[513, 513], metavar=("W", "H"))
    parser.add_argument("-nc", "--num-classes", type=int, default=21)
    parser.add_argument("--weights", type=str, required=True,
                        help="a {'model': state_dict} .pt checkpoint")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--max-batch", type=int, default=8,
                        help="static device batch (requests pad to it; "
                             "bigger = more throughput, more latency)")
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="how long to wait coalescing concurrent "
                             "requests into one batch")
    parser.add_argument("--legacy-preproc", action="store_true")
    opt = parser.parse_args(argv)
    if not os.path.isfile(opt.weights):
        parser.error(f"--weights {opt.weights!r} is not a file")

    import torch

    from .engine.checkpoint import load_model_bundle
    from .models import build_model
    from .serving import MaskServer
    from .utils.runtime import require_cuda

    device = require_cuda()
    model = build_model(opt.model, num_classes=opt.num_classes,
                        dtype=torch.bfloat16, full_res_output=False)
    model = load_model_bundle(model, opt.weights, device)
    server = MaskServer(model, img_size=tuple(opt.img_size),
                        max_batch=opt.max_batch,
                        batch_window_ms=opt.batch_window_ms,
                        legacy_preproc=opt.legacy_preproc)
    host, port = server.start(opt.host, opt.port)[:2]
    print(f"serving {opt.model} ({opt.num_classes} classes, "
          f"{opt.img_size[0]}x{opt.img_size[1]}) on "
          f"{torch.cuda.get_device_name(device)} at http://{host}:{port} "
          f"— POST /predict, GET /healthz", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
