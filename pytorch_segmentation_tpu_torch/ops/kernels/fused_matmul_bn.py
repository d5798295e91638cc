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
note there for their design and what bounds them; bf16 runs all three on the
Hopper `wgmma` + TMA loop, f32 on the older FFMA loop), on a CPU tensor
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
           "bn_act_matmul_dw_reference", "dw_split", "wgmma_tiles",
           "launch_count",
           "reset_launch_count", "layout_copy_count",
           "reset_layout_copy_count"]

_ACT_CODE = {"none": 0, "relu": 1, "relu6": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROW_TILE = 128       # rows of a block's tile in the forward and dx kernels
_DW_K_TILE = 128      # the Hopper dW kernel's K tile (its M tile: wgmma_tiles)
_DW_ROW_STEP = 64     # a split is whole staged steps of the dW kernels
# the dW kernels split N over blocks: as many (K tile, M tile, split)
# blocks as one wave of two blocks on each of an H100's 132 SMs holds, at
# least 256 rows each
_DW_SLOTS = 2 * 132
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
    """(splits, rows per split) of the dW kernels: N is cut into `splits`
    runs of rows, each a multiple of the kernels' row step, so that the
    Hopper kernel's (K tile, M tile, split) blocks fill one wave of the card
    (no more, so that no second wave runs a few blocks alone), with at least
    256 rows a split; only the last run may be shorter. The f32 loop takes
    the same split."""
    tiles = -(-k // _DW_K_TILE) * -(-m // wgmma_tiles(k, m)["dw"])
    splits = max(1, min(_DW_SLOTS // tiles, -(-n // _DW_MIN_ROWS)))
    rows = -(-(-(-n // splits)) // _DW_ROW_STEP) * _DW_ROW_STEP
    return -(-n // rows), rows


@functools.lru_cache(maxsize=1)
def _kernel_fns() -> dict:
    """The library's entry points by name (builds it: card only)."""
    lib = load_kernel_library("fused_matmul_bn")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "fwd": ("pseg_fused_matmul_bn_fwd", [ptr] * 6 + [i32, i64, i32, i32,
                                                         ptr]),
        "bwd_dx": ("pseg_fused_matmul_bn_bwd_dx",
                   [ptr] * 10 + [i32, i64, i32, i32, ptr]),
        "bwd_dw": ("pseg_fused_matmul_bn_bwd_dw",
                   [ptr] * 5 + [i32, i64, i32, i32, i32, i64, ptr]),
        "fwd_wgmma": ("pseg_fused_matmul_bn_fwd_wgmma",
                      [ptr] * 6 + [i32, i64, i32, i32, i32, ptr]),
        "dx_wgmma": ("pseg_fused_matmul_bn_bwd_dx_wgmma",
                     [ptr] * 11 + [i32, i64, i32, i32, i32, i32, ptr]),
        "dw_wgmma": ("pseg_fused_matmul_bn_bwd_dw_wgmma",
                     [ptr] * 5 + [i32, i64, i32, i32, i32, i32, i64, ptr]),
        "smem": ("pseg_fused_matmul_bn_wgmma_smem", [i32, i32]),
    }
    fns = {}
    for key, (name, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns[key] = fn
    return fns


def wgmma_tiles(k: int, m: int) -> dict:
    """The column widths of the Hopper kernels' tiles at (K, M) (rows are
    always 128): {'fwd': width over M, 'dx_dy_tot': width over M, 'dx_dz':
    width over K, 'dw': width over M (its rows are 128 of K)}. 64 for a
    narrow matrix, else 128."""
    def width(cols):
        return 64 if cols <= 64 else 128
    return {"fwd": width(m), "dx_dy_tot": width(m), "dx_dz": width(k),
            "dw": width(m)}


def wgmma_shared_bytes(k: int, m: int) -> dict:
    """The dynamic shared memory each Hopper kernel asks for at (K, M):
    {'fwd', 'dx_dy_tot', 'dx_dz', 'dw'} -> bytes (builds the library: card
    only)."""
    tiles = wgmma_tiles(k, m)
    fn = _kernel_fns()["smem"]
    return {"fwd": fn(tiles["fwd"], k),
            "dx_dy_tot": fn(tiles["dx_dy_tot"], k),
            "dx_dz": fn(tiles["dx_dz"], 0),
            "dw": fn(tiles["dw"], _DW_K_TILE)}


def _raise_on(err: int, what: str) -> None:
    if err >= 10000:
        raise RuntimeError(f"fused_matmul_bn {what}: a TMA descriptor was "
                           f"refused (CUresult {err - 10000})")
    if err != 0:
        raise RuntimeError(f"fused_matmul_bn {what} kernel launch failed: "
                           f"CUDA error {err}")


def _f32_vector(v: torch.Tensor) -> torch.Tensor:
    return v.detach().to(torch.float32).contiguous()


def _launch_fwd(x, scale, shift, wc, act, wt):
    """x [N, K] dense, scale and shift f32 [K], wc [K, M] dense in x's dtype
    and its transpose wt [M, K] (dense) -> (y, col_sum, col_sumsq). bf16
    runs the Hopper kernel, which reads wt; f32 the older loop, which reads
    wc."""
    n, k = x.shape
    m = wc.shape[1]
    fns = _kernel_fns()
    dev = x.device
    y = torch.empty((n, m), dtype=x.dtype, device=dev)
    partials = torch.empty((-(-n // _ROW_TILE), 2, m), dtype=torch.float32,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if x.dtype == torch.bfloat16:
            tiles = wgmma_tiles(k, m)
            err = fns["fwd_wgmma"](
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                wt.data_ptr(), y.data_ptr(), partials.data_ptr(),
                _ACT_CODE[act], n, k, m, tiles["fwd"], stream)
        else:
            err = fns["fwd"](x.data_ptr(), scale.data_ptr(),
                             shift.data_ptr(), wc.data_ptr(), y.data_ptr(),
                             partials.data_ptr(), _ACT_CODE[act], n, k, m,
                             stream)
    _raise_on(err, "forward")
    _launches["fwd"] += 1
    # one slot per row tile, summed in a fixed order: runs are bit-equal
    sums = partials.sum(0)
    return y, sums[0], sums[1]


def _launch_bwd_dx(x, scale, shift, wc, dy, dsum, dsumsq, act, wt):
    """-> (dx, dscale, dshift, dy_tot) (operands as `_launch_fwd`'s); dy_tot
    [N, M] in x's dtype is what the dW kernel reads. bf16 runs the Hopper
    kernels, two grids on the stream counted as one launch; f32 the older
    loop, one block per row tile."""
    n, k = x.shape
    m = wc.shape[1]
    fns = _kernel_fns()
    dev = x.device
    dy_tot = torch.empty((n, m), dtype=x.dtype, device=dev)
    dx = torch.empty((n, k), dtype=x.dtype, device=dev)
    partials = torch.empty((-(-n // _ROW_TILE), 2, k), dtype=torch.float32,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if x.dtype == torch.bfloat16:
            tiles = wgmma_tiles(k, m)
            err = fns["dx_wgmma"](
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                wc.data_ptr(), wt.data_ptr(), dy.data_ptr(), dsum.data_ptr(),
                dsumsq.data_ptr(), dy_tot.data_ptr(), dx.data_ptr(),
                partials.data_ptr(), _ACT_CODE[act], n, k, m,
                tiles["dx_dy_tot"], tiles["dx_dz"], stream)
        else:
            err = fns["bwd_dx"](
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                wc.data_ptr(), dy.data_ptr(), dsum.data_ptr(),
                dsumsq.data_ptr(), dy_tot.data_ptr(), dx.data_ptr(),
                partials.data_ptr(), _ACT_CODE[act], n, k, m, stream)
    _raise_on(err, "dx")
    _launches["bwd_dx"] += 1
    sums = partials.sum(0)
    return dx, sums[0], sums[1], dy_tot


def _launch_bwd_dw(x, scale, shift, dy_tot, act):
    """-> dw f32 [K, M] = z^T @ dy_tot, N split over blocks (`dw_split`):
    each split's f32 partial sums in a slot of their own, summed by
    `partials.sum(0)` (no atomics: launches are bit-equal). bf16 runs the
    Hopper kernel, f32 the older loop."""
    n, k = x.shape
    m = dy_tot.shape[1]
    fns = _kernel_fns()
    dev = x.device
    splits, rows = dw_split(n, k, m)
    partials = torch.empty((splits, k, m), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            dy_tot.data_ptr(), partials.data_ptr(), _ACT_CODE[act], n, k, m)
    with torch.cuda.device(dev):
        if x.dtype == torch.bfloat16:
            err = fns["dw_wgmma"](*args, wgmma_tiles(k, m)["dw"], splits,
                                  rows, stream)
        else:
            err = fns["bwd_dw"](*args, splits, rows, stream)
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
            # one pass each: the cast and the [M, K] -> [K, M] transpose of a
            # convolution weight's view, and (for the wgmma kernels, which
            # read both) the weight as [M, K]
            wc = torch.empty(w.shape, dtype=x.dtype,
                             device=x.device).copy_(w.detach())
            wt = (torch.empty(w.shape[::-1], dtype=x.dtype, device=x.device)
                  .copy_(w.detach().t()) if x.dtype == torch.bfloat16
                  else wc)
            scale32, shift32 = _f32_vector(scale), _f32_vector(shift)
            out = _launch_fwd(x, scale32, shift32, wc, act, wt)
            ctx.save_for_backward(x, scale32, shift32, wc, wt)
        else:
            out = bn_act_matmul_reference(x, scale, shift, w, act)
            ctx.save_for_backward(x, scale, shift, w, w)
        ctx.vector_dtypes = (scale.dtype, shift.dtype)
        return out

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        x, scale, shift, w, wt = ctx.saved_tensors
        if x.device.type == "cuda":
            dx, dscale, dshift, dy_tot = _launch_bwd_dx(
                x, scale, shift, w, _dense_rows(dy), _f32_vector(dsum),
                _f32_vector(dsumsq), ctx.act, wt)
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
