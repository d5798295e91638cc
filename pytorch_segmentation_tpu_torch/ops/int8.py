"""Exact int8 convolution (the int8 branch of the JAX package's ConvNormAct,
which runs XLA's `conv_general_dilated(..., preferred_element_type=int32)`).

One route on the card and on the CPU: the NHWC view of the int8 input is
unfolded into a [B*Ho*Wo, kh*kw*Cin] matrix by slicing (a 1x1 conv only
slices the stride), and `torch._int_mm` multiplies it by the kernel's
[kh*kw*Cin, Cout] matrix with int32 accumulation. Every step is exact:
slices and zero padding copy int8 values, and an int32 sum of products of
int8 values in [-127, 127] is exact in any order. `torch._int_mm`'s CUDA
rules (more than 16 rows, K and N multiples of 8) are met by zero rows and
columns, which add nothing; a shape it still refuses raises.

`int8_conv2d_plain` is the f64 `F.conv2d` of the same integers, exact
because |sum| <= 127^2 * K stays far below 2^53: the reference that the
tests and the smoke run hold `int8_conv2d` to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["int8_conv2d", "int8_conv2d_plain"]

_MIN_ROWS = 17   # torch._int_mm on CUDA takes more than 16 rows
_ALIGN = 8       # ... and K, N multiples of 8


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int8_matmul(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] times int8 b_nk [N, K] transposed -> int32 [M, N]
    (a view of the padded product where padding was needed)."""
    m, k = a.shape
    n = b_nk.shape[0]
    kp, np_, mp = _up(k, _ALIGN), _up(n, _ALIGN), max(m, _MIN_ROWS)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_nk = F.pad(b_nk, (0, kp - k, 0, np_ - n))
    # row-major A and column-major B: the layout cuBLASLt's int8 product takes
    y = torch._int_mm(a.contiguous(), b_nk.contiguous().t())
    return y[:m, :n]


def _out_size(size: int, k: int, stride: int, padding: int,
              dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """x_q: int8 [B, Cin, H, W] (NCHW, channels_last memory read without a
    copy); w_q: int8 [Cout, Cin, k, k]; symmetric zero padding. Returns
    the int32 convolution [B, Cout, Ho, Wo] with channels_last memory."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 operands, not {x_q.dtype} "
                        f"and {w_q.dtype}")
    b, cin, h, w = x_q.shape
    cout, wcin, k, kw = w_q.shape
    if wcin != cin or kw != k:
        raise ValueError(f"kernel {tuple(w_q.shape)} for input "
                         f"{tuple(x_q.shape)}: square kernels, groups 1")
    ho = _out_size(h, k, stride, padding, dilation)
    wo = _out_size(w, k, stride, padding, dilation)
    x = x_q.permute(0, 2, 3, 1)                       # NHWC view
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    rows = (ho - 1) * stride + 1
    cols = (wo - 1) * stride + 1
    taps = [x[:, i * dilation:i * dilation + rows:stride,
              j * dilation:j * dilation + cols:stride, :]
            for i in range(k) for j in range(k)]
    # [B*Ho*Wo, k*k*Cin] in (kh, kw, Cin) order, the kernel's likewise
    a = (taps[0] if k == 1 else torch.stack(taps, dim=3)).reshape(
        b * ho * wo, k * k * cin)
    w_mat = w_q.permute(0, 2, 3, 1).reshape(cout, k * k * cin)
    y = _int8_matmul(a, w_mat)
    return y.view(b, ho, wo, cout).permute(0, 3, 1, 2)


def int8_conv2d_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                      padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """The same int32 convolution as an f64 F.conv2d of the integers."""
    y = F.conv2d(x_q.double(), w_q.double(), None, stride, padding,
                 dilation)
    return y.to(torch.int32)
