#!/usr/bin/env python3
"""The row resampler of the augmentation warp alone, on the card, at the two
calls the default policy makes on a real batch: 32 seeded u8 images and
label maps of 513 x 513 go through `PostFetch(make_augment_fn())` (bf16),
whose two resampler calls are captured with their arguments. The first pass
reads a contiguous source [32, 4, 513, 513] bf16, the second the transposed
view of the first pass's output; both write bf16, at f32 coordinates
[32, 513, 513]. The first pass is also timed writing f32.

It prints the card's name and power limit, then for each case the ms of
`_launch` (the output's allocation and the kernel), CUDA events around one
call, median of 20 after 3 warm-ups, and its device time: 20 calls queued
behind a sleep kernel run back to back, their events' time over 20, median
of 5 (an event pair around one call also holds the host's enqueue). Beside
them the card's bound for the same work: the planes, coordinates and
use_bil read once and the output written once, at 3.35 TB/s.
`--save PATH` writes each case's output and a digest of its inputs, so that
two checkouts' kernels can be timed and held against each other on the same
inputs in one call: `--compare A B` reads two such files and prints, per
case, whether the inputs and the outputs are equal and how many output
entries differ. (The second pass's source is the first pass's output, so
its inputs are equal only where the first passes agree.)

The script imports the package by its absolute name, so run as a file with
PYTHONPATH set to the root of a checkout it times that checkout's kernel
(the checkout needs `_launch(planes, coords, use_bil, out_dtype)`):

    PYTHONPATH=. python pytorch_segmentation_tpu_torch/tools/bench_resample.py \
        --save build/new.pt
    PYTHONPATH=path/to/older python \
        pytorch_segmentation_tpu_torch/tools/bench_resample.py \
        --save build/old.pt
    python -m pytorch_segmentation_tpu_torch.tools.bench_resample \
        --compare build/old.pt build/new.pt
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import numpy as np
import torch

from pytorch_segmentation_tpu_torch.data import augment as taug
from pytorch_segmentation_tpu_torch.data.loader import Batch
from pytorch_segmentation_tpu_torch.data.pipeline import PostFetch
from pytorch_segmentation_tpu_torch.ops.kernels import banded_resample as br
from pytorch_segmentation_tpu_torch.tools.bench_eval_confusion import (
    queued_ms, timed_ms)

BATCH, IMG, CLASSES, SEED = 32, 513, 21, 0
HBM_BYTES_PER_S = 3.35e12


def seeded_batch() -> Batch:
    """Smooth u8 images (bilinear up from 17 x 17) and, as labels, a 9 x 9
    grid of classes per image, nearest-upsampled."""
    rng = np.random.default_rng(SEED)
    small = torch.from_numpy(rng.integers(0, 256, (BATCH, 3, 17, 17))
                             .astype(np.float32))
    images = torch.nn.functional.interpolate(
        small, (IMG, IMG), mode="bilinear", align_corners=True)
    images = images.round().clamp(0, 255).to(torch.uint8)
    grid = torch.from_numpy(rng.integers(0, CLASSES, (BATCH, 1, 9, 9))
                            .astype(np.float32))
    segs = torch.nn.functional.interpolate(grid, (IMG, IMG), mode="nearest")
    return Batch(images.permute(0, 2, 3, 1).contiguous().numpy(),
                 segs[:, 0].to(torch.uint8).numpy(), BATCH)


def capture_calls(device):
    """The two resampler calls of one augmented batch:
    [(planes, coords, use_bil, kwargs)]."""
    calls = []
    real = taug.banded_resample_rows

    def recording(planes, coords, use_bil, **kwargs):
        calls.append((planes, coords, use_bil, kwargs))
        return real(planes, coords, use_bil, **kwargs)

    post = PostFetch(taug.make_augment_fn(), dtype=torch.bfloat16, seed=SEED,
                     device=device)
    taug.banded_resample_rows = recording
    try:
        post(seeded_batch())
    finally:
        taug.banded_resample_rows = real
    torch.cuda.synchronize()
    if len(calls) != 2:
        raise AssertionError(f"one augmented batch made {len(calls)} "
                             f"resampler calls, not 2")
    return calls


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def bound_ms(planes, coords, use_bil, out_dtype) -> float:
    out_bytes = (4 * coords.numel()
                 * torch.empty((), dtype=out_dtype).element_size())
    n_bytes = (planes.numel() * planes.element_size() + 4 * coords.numel()
               + use_bil.numel() + out_bytes)
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def run(args):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool runs only on the GPU")
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    (p1, c1, ub, _), (p2, c2, _, _) = capture_calls(device)
    cases = {"pass1_bf16": (p1, c1, torch.bfloat16),
             "pass2_bf16_transposed_view": (p2, c2, torch.bfloat16),
             "pass1_f32": (p1, c1, torch.float32)}
    saved = {}
    for name, (planes, coords, out_dtype) in cases.items():
        def call():
            return br._launch(planes, coords, ub, out_dtype)

        out = call()
        torch.cuda.synchronize()
        saved[name] = {"inputs": digest(planes, coords, ub),
                       "out": out.cpu()}
        del out
        print(json.dumps({
            "case": name, "planes_strides": list(planes.stride()),
            "out_dtype": str(out_dtype).replace("torch.", ""),
            "launch_ms": timed_ms(call), "launch_device_ms": queued_ms(call),
            "bound_ms": bound_ms(planes, coords, ub, out_dtype)}),
            flush=True)
    if args.save:
        torch.save(saved, args.save)


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    for name in a:
        x, y = a[name]["out"], b[name]["out"]
        print(json.dumps({
            "case": name,
            "inputs_equal": a[name]["inputs"] == b[name]["inputs"],
            "outputs_equal": bool(torch.equal(x, y)),
            "entries_differing": int((x != y).sum())}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save", help="write the outputs (.pt)")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"),
                        help="compare two files written by --save")
    args = parser.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(args)


if __name__ == "__main__":
    main()
