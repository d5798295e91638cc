#!/usr/bin/env python3
"""The upsample+argmax kernel alone, on the card, at the serving shape:
logits [8, 129, 129, 21] -> mask 513 x 513, align_corners, bf16 and f32
logits, channels-last and from NCHW memory (the strided view a convolution
leaves), inputs from a seed; and one downsampled shape, logits wider than
the mask: [1, 4, 3000, 150] f32 -> (6, 300).

It prints the card's name and power limit, then for each case the ms of
`_launch` (the mask's allocation and the kernel), CUDA events around one
call, median of 20 after 3 warm-ups, and its device time: 20 calls queued
behind a sleep kernel run back to back, their events' time over 20, median
of 5 (an event pair around one call also holds the host's enqueue). Beside
them the card's bound: the logits read once and the int32 mask written once
at 3.35 TB/s, or the separable interpolation and a compare per pixel and
class at 67 TFLOP/s, whichever is larger.
`--save PATH` writes each case's mask, so that two checkouts' kernels can be
timed and held against each other on the same inputs in one call:
`--compare A B` reads two such files and prints, per case, whether the masks
are equal and how many pixels differ.

The script imports the package by its absolute name, so run as a file with
PYTHONPATH set to the root of a checkout it times that checkout's kernel
(the checkout needs `_launch(logits, out_hw, align_corners)`):

    PYTHONPATH=. python \
        pytorch_segmentation_tpu_torch/tools/bench_upsample_argmax.py \
        --save build/new.pt
    PYTHONPATH=path/to/older python \
        pytorch_segmentation_tpu_torch/tools/bench_upsample_argmax.py \
        --save build/old.pt
    python -m pytorch_segmentation_tpu_torch.tools.bench_upsample_argmax \
        --compare build/old.pt build/new.pt
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from pytorch_segmentation_tpu_torch.ops.kernels import upsample_argmax as ua
from pytorch_segmentation_tpu_torch.tools.bench_eval_confusion import (
    queued_ms, timed_ms)

SEED = 0
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12
# name -> (logits shape, mask (H, W), dtype, NCHW memory)
CASES = {
    "path_bf16": ((8, 129, 129, 21), (513, 513), torch.bfloat16, False),
    "path_bf16_nchw": ((8, 129, 129, 21), (513, 513), torch.bfloat16, True),
    "path_f32": ((8, 129, 129, 21), (513, 513), torch.float32, False),
    "path_f32_nchw": ((8, 129, 129, 21), (513, 513), torch.float32, True),
    "downsampled_c150_f32": ((1, 4, 3000, 150), (6, 300), torch.float32,
                             False),
}


def seeded_logits(shape, dtype, nchw, device):
    x = np.random.default_rng(SEED).standard_normal(shape).astype(np.float32)
    logits = torch.from_numpy(x).to(device=device, dtype=dtype)
    if nchw:
        logits = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return logits


def bound(shape, out_hw, elem_size):
    """(ms, "bytes" or "operations"): per output pixel and class the
    separable interpolation (rows first: 3 w / out_w flops, then 3) and one
    compare."""
    b, _, w, c = shape
    pixels = b * out_hw[0] * out_hw[1]
    by_bytes = 1e3 * (np.prod(shape) * elem_size + 4 * pixels) / \
        HBM_BYTES_PER_S
    by_ops = 1e3 * (3.0 * w / out_hw[1] + 4.0) * pixels * c / F32_FLOPS
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def run(args):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool runs only on the GPU")
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    saved = {}
    for name, (shape, out_hw, dtype, nchw) in CASES.items():
        x = seeded_logits(shape, dtype, nchw, device)

        def call():
            return ua._launch(x, out_hw, True)

        saved[name] = call().cpu()
        ms, by = bound(shape, out_hw, x.element_size())
        print(json.dumps({
            "case": name, "shape": list(shape), "out_hw": list(out_hw),
            "strides": list(x.stride()), "launch_ms": timed_ms(call),
            "launch_device_ms": queued_ms(call), "bound_ms": ms,
            "bound_by": by}), flush=True)
    if args.save:
        torch.save(saved, args.save)


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    for name in a:
        print(json.dumps({"case": name,
                          "masks_equal": bool(torch.equal(a[name], b[name])),
                          "pixels_differing": int((a[name] != b[name]).sum()),
                          "pixels": a[name].numel()}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save", help="write the masks (.pt)")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"),
                        help="compare two files written by --save")
    args = parser.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(args)


if __name__ == "__main__":
    main()
