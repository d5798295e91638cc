"""Channels-major 1x1 convolution as one matrix product: Y[co, pix] =
W[co, ci] @ X[ci, pix], with the pixels in the contiguous dimension of X and
Y (port of `pallas_cmajor` / `_mm_kernel` in tools/bench_cmajor.py). bf16
operands, f32 sums, f32 output.

On a CUDA tensor `cmajor_matmul` launches the hand-written kernel
`hop::cmajor_wgmma_kernel` of `csrc/fused_matmul_bn.cu` (entry point
`pseg_cmajor_matmul`): the fused 1x1 kernels' Hopper loop (TMA + `wgmma`)
without prologue, W read K-major and X MN-major (the pixels contiguous),
128 x 128 tiles, or 64 x 128 with the pixels split between the two
warpgroups where co <= 64, and an f32 epilogue of 16-byte stores. On a CPU
tensor it runs `cmajor_matmul_reference`, the plain PyTorch version. A CUDA
tensor gets the kernel or an exception. Only
`tools/bench_cmajor.py` calls it: the question it answers is whether the
small-channel products of ResNet's first stage run better with the pixels,
not the channels, across a tile's columns.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernel_library

__all__ = ["cmajor_matmul", "cmajor_matmul_reference", "wgmma_product",
           "launch_count", "reset_launch_count"]

_launches = 0


def launch_count() -> int:
    """How many times the CUDA kernel has been launched in this process."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def cmajor_matmul_reference(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the f32 product of the bf16-rounded
    operands (their products are exact in f32)."""
    return (w.to(torch.bfloat16).float() @ x.to(torch.bfloat16).float())


@functools.lru_cache(maxsize=1)
def _kernel_fns():
    lib = load_kernel_library("fused_matmul_bn")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    cmajor = lib.pseg_cmajor_matmul
    cmajor.restype = ctypes.c_int
    cmajor.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_int64, ptr]
    product = lib.pseg_wgmma_product
    product.restype = ctypes.c_int
    product.argtypes = [ptr, ptr, ptr] + [i32] * 5 + [ptr]
    return cmajor, product


def _raise_on(err: int, what: str) -> None:
    if err >= 10000:
        raise RuntimeError(f"{what}: a TMA descriptor was refused "
                           f"(CUresult {err - 10000})")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _dense_on_card(*tensors) -> None:
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("the kernel needs contiguous, 16-byte aligned "
                         "operands")


def cmajor_matmul(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [co, ci] and x [ci, pix], both bf16 and contiguous, ci and pix
    multiples of 8 -> y [co, pix] f32."""
    global _launches
    if w.dim() != 2 or x.dim() != 2 or w.shape[1] != x.shape[0]:
        raise ValueError(f"w must be [co, ci] and x [ci, pix], got "
                         f"{tuple(w.shape)} and {tuple(x.shape)}")
    if w.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError(f"cmajor_matmul takes bfloat16 operands, not "
                        f"{w.dtype} and {x.dtype}")
    co, ci = w.shape
    pix = x.shape[1]
    if co < 1 or ci < 8 or pix < 8 or ci % 8 or pix % 8:
        raise ValueError(f"ci and pix must be multiples of 8, got {ci} and "
                         f"{pix} (co {co})")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        return cmajor_matmul_reference(w, x)
    if x.device.type != "cuda":
        raise ValueError(f"cmajor_matmul: no path for device {x.device}")
    _dense_on_card(w, x)
    y = torch.empty((co, pix), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fns()[0](w.data_ptr(), x.data_ptr(), y.data_ptr(), co,
                               ci, pix, stream)
    _raise_on(err, "cmajor_matmul")
    _launches += 1
    return y


def wgmma_product(a: torch.Tensor, b: torch.Tensor, a_mn: bool,
                  b_mn: bool) -> torch.Tensor:
    """C = A @ B in f32 through the same kernel with each operand in either
    major-ness, for the card test of the loop's shared-memory descriptors
    (not counted: no path of the port calls it). `a` holds A [rows, depth],
    or with a_mn its transpose [depth, rows]; `b` holds B [depth, cols]
    with b_mn, else its transpose [cols, depth]. bf16 CUDA tensors, every
    extent a multiple of 8."""
    rows, depth = a.shape[::-1] if a_mn else a.shape
    cols = b.shape[1] if b_mn else b.shape[0]
    if (a.dtype, b.dtype) != (torch.bfloat16, torch.bfloat16) or (
            (b.shape[0] if b_mn else b.shape[1]) != depth):
        raise ValueError(f"bf16 operands of one depth, got {a.dtype} "
                         f"{tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"operands on one CUDA device, got {a.device} and "
                         f"{b.device}")
    _dense_on_card(a, b)
    c = torch.empty((rows, cols), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _kernel_fns()[1](a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               rows, cols, depth, int(a_mn), int(b_mn),
                               stream)
    _raise_on(err, "wgmma_product")
    return c
