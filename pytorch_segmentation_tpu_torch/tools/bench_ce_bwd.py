#!/usr/bin/env python3
"""The upsample+cross-entropy backward kernel alone, on the card, at the
train step's shape: logits [32, 129, 129, 21] -> labels 513 x 513,
align_corners, bf16 and f32 logits, inputs from a seed.

It prints the card's name and power limit, then for each dtype the ms of
`_launch_bwd` on the forward's saved tensors (CUDA events, median of 20
after 3 warm-ups). `--save PATH` writes the gradients of both dtypes, so
that two checkouts' kernels can be timed and held against each other bit
for bit on the same inputs in one call: `--compare A B` reads two such
files and prints, per dtype, whether they are equal and by how much they
differ.

The script imports the package by its absolute name, so run as a file with
PYTHONPATH set to the root of a checkout it times that checkout's kernel
(the tools directory is not in an older checkout):

    PYTHONPATH=. python pytorch_segmentation_tpu_torch/tools/bench_ce_bwd.py \
        --save new.pt
    PYTHONPATH=path/to/older python \
        pytorch_segmentation_tpu_torch/tools/bench_ce_bwd.py --save old.pt
    python -m pytorch_segmentation_tpu_torch.tools.bench_ce_bwd \
        --compare old.pt new.pt
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from pytorch_segmentation_tpu_torch.ops.kernels import softmax_ce as ce

SHAPE, OUT_HW, SEED = (32, 129, 129, 21), (513, 513), 0
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def timed_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def saved_tensors(dtype, device):
    """What the forward keeps for the backward, on seeded inputs."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)).to(
        device=device, dtype=dtype)
    y = torch.from_numpy(rng.integers(0, SHAPE[-1], (SHAPE[0],) + OUT_HW)).to(
        device=device, dtype=torch.int32)
    _, lse, labels = ce._launch_fwd(x, y, True, want_lse=True)
    return x, labels, lse, torch.ones((), device=device)


def run(args):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool runs only on the GPU")
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    grads = {}
    for name, dtype in DTYPES.items():
        x, labels, lse, g = saved_tensors(dtype, device)
        grads[name] = ce._launch_bwd(x, labels, lse, g, True)
        torch.cuda.synchronize()
        ms = timed_ms(lambda: ce._launch_bwd(x, labels, lse, g, True))
        print(json.dumps({"dtype": name, "kernel_ms": ms}), flush=True)
    if args.save:
        torch.save({k: v.cpu() for k, v in grads.items()}, args.save)


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    for name in DTYPES:
        diff = (a[name].float() - b[name].float()).abs()
        print(json.dumps({
            "dtype": name, "bit_equal": bool(torch.equal(a[name], b[name])),
            "elements_differing": int((a[name] != b[name]).sum()),
            "max_abs_diff": float(diff.max()),
            "largest_entry": float(a[name].float().abs().max())}),
            flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save", help="write the gradients here (.pt)")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"),
                        help="compare two files written by --save")
    args = parser.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(args)


if __name__ == "__main__":
    main()
