"""BN-apply + activation + 1x1 convolution + BN statistics in one pass (port
of pytorch_segmentation_tpu/ops/pallas/fused_matmul_bn.py).

    z = act(x * scale + shift)        the PREVIOUS layer's BN-apply, in x's
                                      dtype (the product rounded, then the sum)
    y32 = z @ w                       operands in x's dtype, f32 sums
    y = y32 in x's dtype; col_sum = sum_n y32; col_sumsq = sum_n y32^2

so the raw input is never normalized in device memory and the output is
never read again for THIS layer's BN statistics. `scale` and `shift` are the
per-channel fold of the previous BatchNorm (`nn.blocks.BatchNorm2d.fold`),
which stays plain PyTorch, so autograd reaches gamma and beta through this
function's gradients.

`fused_bn_act_matmul` is a `torch.autograd.Function` with gradients for x,
scale, shift and w and cotangents for all three outputs. On a CUDA tensor its
forward and backward launch the hand-written kernels of
`csrc/fused_matmul_bn.cu` (forward; dx with dscale and dshift; dW: see the
note there for their design and what bounds them), on a CPU tensor
`bn_act_matmul_reference` and `bn_act_matmul_backward_reference`, the plain
PyTorch versions that the tests hold against the JAX package. There is no
fallback from one to the other: a CUDA tensor gets the kernels or an
exception.

The backward mirrors the kernels' arithmetic: the statistics' cotangents are
folded into the product's, `dy_tot = dy + dsum + 2 * y32 * dsumsq` with y32
recomputed, and rounded to x's dtype before both products; the activation's
mask comes from `pre = x * scale + shift` in f32 (the forward's z comes from
arithmetic in x's dtype; where pre nearly cancels the two may disagree on the
sign, and kernel and plain version must agree on the mask exactly).

The kernels read dense row-major `[N, K]` rows. A model in channels_last
hands them a view with contiguous rows; where the rows of x (or of the
incoming dy) are not contiguous the wrapper makes one copy and counts it
(`layout_copy_count`), never silently.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernel_library

__all__ = ["fused_bn_act_matmul", "bn_act_matmul_reference",
           "bn_act_matmul_backward_reference", "bn_act_matmul_dx_reference",
           "bn_act_matmul_dw_reference", "dw_split", "launch_count",
           "reset_launch_count", "layout_copy_count",
           "reset_layout_copy_count"]

_ACT_CODE = {"none": 0, "relu": 1, "relu6": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROW_TILE = 128       # rows of a block's tile in the forward and dx kernels
_DW_TILE = (128, 64)  # the dW kernel's (K, M) tile
_DW_ROW_STEP = 64     # a split is whole staged steps of the dW kernel
# the dW kernel splits N over blocks: enough blocks for two waves of two
# blocks on each of an H100's 132 SMs, at least 256 rows each
_DW_TARGET_BLOCKS = 528
_DW_MIN_ROWS = 256
_launches = {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}
_layout_copies = 0


def launch_count() -> dict:
    """How many times each CUDA kernel has been launched in this process:
    {'fwd': n, 'bwd_dx': n, 'bwd_dw': n}."""
    return dict(_launches)


def reset_launch_count() -> None:
    for key in _launches:
        _launches[key] = 0


def layout_copy_count() -> int:
    """How many times the wrapper copied an x or a dy whose rows were not
    contiguous (or, on the card, not 16-byte aligned) before handing it
    on."""
    return _layout_copies


def reset_layout_copy_count() -> None:
    global _layout_copies
    _layout_copies = 0


def _dense_rows(t: torch.Tensor) -> torch.Tensor:
    """`t` with contiguous, 16-byte aligned rows: itself, or a counted
    copy."""
    global _layout_copies
    aligned = t.device.type != "cuda" or t.data_ptr() % 16 == 0
    if t.is_contiguous() and aligned:
        return t
    _layout_copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the sums: f32 (f64 for an f64 gradient check)."""
    return torch.promote_types(dtype, torch.float32)


def _act(pre: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(pre)
    if act == "relu6":
        return pre.clamp(0.0, 6.0)
    return pre


def _act_grad_mask(pre: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return pre > 0
    if act == "relu6":
        return (pre > 0) & (pre < 6)
    return torch.ones_like(pre, dtype=torch.bool)


def _y32(x, scale, shift, w, act):
    """y32 = z @ w with f32 sums, z = act(x * scale + shift) in x's dtype.
    The products of two bf16 values are exact in f32, so this is "bf16
    operands, f32 accumulate" on the CPU and the card alike; a bf16 matmul's
    bf16 output would lose the sums the statistics need."""
    dt = x.dtype
    acc = _acc_dtype(dt)
    z = _act(x * scale.to(dt) + shift.to(dt), act)
    return z.to(acc) @ w.to(dt).to(acc)


def bn_act_matmul_reference(x: torch.Tensor, scale: torch.Tensor,
                            shift: torch.Tensor, w: torch.Tensor,
                            act: str = "relu"):
    """The plain PyTorch version of the forward: x [N, K], scale and shift
    [K], w [K, M] -> (y [N, M] in x's dtype, col_sum [M], col_sumsq [M] of
    the f32 y before that rounding). Differentiable by autograd."""
    y32 = _y32(x, scale, shift, w, act)
    return y32.to(x.dtype), y32.sum(0), (y32 * y32).sum(0)


def bn_act_matmul_dx_reference(x, scale, shift, w, dy, dsum, dsumsq,
                               act: str = "relu"):
    """The plain PyTorch version of the dx kernel -> (dx [N, K] in x's
    dtype, dscale [K] f32, dshift [K] f32, dy_tot [N, M] in x's dtype)."""
    dt = x.dtype
    acc = _acc_dtype(dt)
    y32 = _y32(x, scale, shift, w, act)
    dy_tot = (dy.to(acc) + dsum.to(acc) + 2.0 * y32 * dsumsq.to(acc)).to(dt)
    scale = scale.to(acc)
    xf = x.to(acc)
    pre = xf * scale + shift.to(acc)
    dz = ((dy_tot.to(acc) @ w.to(dt).to(acc).t())
          * _act_grad_mask(pre, act).to(acc))
    return (dz * scale).to(dt), (dz * xf).sum(0), dz.sum(0), dy_tot


def bn_act_matmul_dw_reference(x, scale, shift, dy_tot, act: str = "relu"):
    """The plain PyTorch version of the dW kernel -> dw [K, M] f32 =
    z^T @ dy_tot, z as the forward forms it."""
    dt = x.dtype
    acc = _acc_dtype(dt)
    z = _act(x * scale.to(dt) + shift.to(dt), act)
    return z.to(acc).t() @ dy_tot.to(acc)


def bn_act_matmul_backward_reference(x, scale, shift, w, dy, dsum, dsumsq,
                                     act: str = "relu"):
    """The plain PyTorch version of the backward, with the kernels'
    arithmetic -> (dx [N, K] in x's dtype, dscale [K], dshift [K],
    dw [K, M]; the last three in f32)."""
    dx, dscale, dshift, dy_tot = bn_act_matmul_dx_reference(
        x, scale, shift, w, dy, dsum, dsumsq, act)
    return dx, dscale, dshift, bn_act_matmul_dw_reference(x, scale, shift,
                                                          dy_tot, act)


def dw_split(n: int, k: int, m: int) -> tuple[int, int]:
    """(splits, rows per split) of the dW kernel: N is cut into `splits`
    runs of rows, each a multiple of the kernel's row step, so that the
    (K tile, M tile, split) blocks fill the card while the f32 partials
    [splits, K, M] stay small."""
    tiles = -(-k // _DW_TILE[0]) * -(-m // _DW_TILE[1])
    splits = max(1, min(-(-_DW_TARGET_BLOCKS // tiles),
                        -(-n // _DW_MIN_ROWS)))
    rows = -(-(-(-n // splits)) // _DW_ROW_STEP) * _DW_ROW_STEP
    return -(-n // rows), rows


@functools.lru_cache(maxsize=1)
def _kernel_fns():
    lib = load_kernel_library("fused_matmul_bn")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fwd = lib.pseg_fused_matmul_bn_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ptr] * 6 + [i32, i32, i64, i32, i32, ptr]
    bwd_dx = lib.pseg_fused_matmul_bn_bwd_dx
    bwd_dx.restype = ctypes.c_int
    bwd_dx.argtypes = [ptr] * 10 + [i32, i32, i64, i32, i32, ptr]
    bwd_dw = lib.pseg_fused_matmul_bn_bwd_dw
    bwd_dw.restype = ctypes.c_int
    bwd_dw.argtypes = [ptr] * 5 + [i32, i32, i64, i32, i32, i32, i64, ptr]
    return fwd, bwd_dx, bwd_dw


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused_matmul_bn {what} kernel launch failed: "
                           f"CUDA error {err}")


def _f32_vector(v: torch.Tensor) -> torch.Tensor:
    return v.detach().to(torch.float32).contiguous()


def _launch_fwd(x, scale, shift, wc, act):
    """x [N, K] dense, scale and shift f32 [K], wc [K, M] dense in x's dtype
    -> (y, col_sum, col_sumsq)."""
    fwd, _, _ = _kernel_fns()
    n, k = x.shape
    m = wc.shape[1]
    dev = x.device
    y = torch.empty((n, m), dtype=x.dtype, device=dev)
    partials = torch.empty((-(-n // _ROW_TILE), 2, m), dtype=torch.float32,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fwd(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  wc.data_ptr(), y.data_ptr(), partials.data_ptr(),
                  _DTYPE_CODE[x.dtype], _ACT_CODE[act], n, k, m, stream)
    _raise_on(err, "forward")
    _launches["fwd"] += 1
    # one slot per row tile, summed in a fixed order: runs are bit-equal
    sums = partials.sum(0)
    return y, sums[0], sums[1]


def _launch_bwd_dx(x, scale, shift, wc, dy, dsum, dsumsq, act):
    """-> (dx, dscale, dshift, dy_tot); dy_tot [N, M] in x's dtype is what
    the dW kernel reads."""
    _, bwd_dx, _ = _kernel_fns()
    n, k = x.shape
    m = wc.shape[1]
    dev = x.device
    dy_tot = torch.empty((n, m), dtype=x.dtype, device=dev)
    dx = torch.empty((n, k), dtype=x.dtype, device=dev)
    partials = torch.empty((-(-n // _ROW_TILE), 2, k), dtype=torch.float32,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = bwd_dx(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                     wc.data_ptr(), dy.data_ptr(), dsum.data_ptr(),
                     dsumsq.data_ptr(), dy_tot.data_ptr(), dx.data_ptr(),
                     partials.data_ptr(), _DTYPE_CODE[x.dtype],
                     _ACT_CODE[act], n, k, m, stream)
    _raise_on(err, "dx")
    _launches["bwd_dx"] += 1
    sums = partials.sum(0)
    return dx, sums[0], sums[1], dy_tot


def _launch_bwd_dw(x, scale, shift, dy_tot, act):
    """-> dw f32 [K, M] = z^T @ dy_tot."""
    _, _, bwd_dw = _kernel_fns()
    n, k = x.shape
    m = dy_tot.shape[1]
    dev = x.device
    splits, rows = dw_split(n, k, m)
    partials = torch.empty((splits, k, m), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = bwd_dw(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                     dy_tot.data_ptr(), partials.data_ptr(),
                     _DTYPE_CODE[x.dtype], _ACT_CODE[act], n, k, m, splits,
                     rows, stream)
    _raise_on(err, "dW")
    _launches["bwd_dw"] += 1
    return partials[0] if splits == 1 else partials.sum(0)


class _FusedBnActMatmul(torch.autograd.Function):
    """x [N, K] with dense rows; the kernels on a CUDA tensor, the plain
    versions on a CPU tensor. Keeps x, the two vectors and w in x's dtype
    for the backward, which recomputes z and y32."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, act):
        ctx.act = act
        ctx.w_dtype = w.dtype
        if x.device.type == "cuda":
            # one pass: the cast and the [M, K] -> [K, M] transpose of a
            # convolution weight's view
            wc = torch.empty(w.shape, dtype=x.dtype,
                             device=x.device).copy_(w.detach())
            scale32, shift32 = _f32_vector(scale), _f32_vector(shift)
            out = _launch_fwd(x, scale32, shift32, wc, act)
            ctx.save_for_backward(x, scale32, shift32, wc)
        else:
            out = bn_act_matmul_reference(x, scale, shift, w, act)
            ctx.save_for_backward(x, scale, shift, w)
        ctx.vector_dtypes = (scale.dtype, shift.dtype)
        return out

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        x, scale, shift, w = ctx.saved_tensors
        if x.device.type == "cuda":
            dx, dscale, dshift, dy_tot = _launch_bwd_dx(
                x, scale, shift, w, _dense_rows(dy), _f32_vector(dsum),
                _f32_vector(dsumsq), ctx.act)
            dw = (_launch_bwd_dw(x, scale, shift, dy_tot, ctx.act)
                  if ctx.needs_input_grad[3] else None)
        else:
            dx, dscale, dshift, dw = bn_act_matmul_backward_reference(
                x, scale, shift, w, dy, dsum, dsumsq, ctx.act)
        if dw is not None:
            dw = dw.to(ctx.w_dtype)
        return (dx, dscale.to(ctx.vector_dtypes[0]),
                dshift.to(ctx.vector_dtypes[1]), dw, None)


def _check(x, scale, shift, w, act) -> None:
    if act not in _ACT_CODE:
        raise ValueError(f"act must be one of {sorted(_ACT_CODE)}, not "
                         f"{act!r}")
    if x.dim() < 1 or w.dim() != 2 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"x must be [..., K] and w [K, M], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k, m = w.shape
    if scale.shape != (k,) or shift.shape != (k,):
        raise ValueError(f"scale and shift must be [{k}], got "
                         f"{tuple(scale.shape)} and {tuple(shift.shape)}")
    if k < 8 or m < 8 or k % 8 or m % 8:
        raise ValueError(f"K and M must be multiples of 8, got {k} and {m}")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if any(t.device != x.device for t in (scale, shift, w)):
        raise ValueError(f"x on {x.device}, scale, shift and w on "
                         f"{scale.device}, {shift.device}, {w.device}")
    allowed = (tuple(_DTYPE_CODE) if x.device.type == "cuda"
               else (*_DTYPE_CODE, torch.float64))
    if x.dtype not in allowed:
        raise TypeError(f"fused_bn_act_matmul takes float32 or bfloat16 "
                        f"activations, not {x.dtype}")


def fused_bn_act_matmul(x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, w: torch.Tensor,
                        act: str = "relu"):
    """act(x * scale + shift) @ w with the output's BN statistics (act:
    'relu' | 'relu6' | 'none', the previous layer's nonlinearity).

    x: [..., K] in the compute dtype (f32 or bf16), flattened to [N, K];
    scale, shift: [K] f32, the previous BatchNorm's fold; w: [K, M], any
    float dtype and strides (cast to x's dtype). K and M are multiples of 8.
    Returns (y [..., M] in x's dtype, col_sum [M] f32, col_sumsq [M] f32).

    CUDA tensors go through the hand-written kernels, CPU tensors through
    the plain versions (which also take f64, for gradient checks); any other
    device raises."""
    _check(x, scale, shift, w, act)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_bn_act_matmul: no path for device "
                         f"{x.device}")
    lead = x.shape[:-1]
    x = _dense_rows(x)
    y, col_sum, col_sumsq = _FusedBnActMatmul.apply(
        x.view(-1, x.shape[-1]), scale, shift, w, act)
    return y.view(*lead, w.shape[1]), col_sum, col_sumsq
