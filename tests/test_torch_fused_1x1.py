"""PyTorch port: the opt-in fused 1x1 path (BN-apply + activation + product
+ BN statistics, `ops/kernels/fused_matmul_bn.py`; `BatchNorm2d.fold`,
`ConvNormAct.folded`, the folded `Bottleneck`) and the channels-major
product against the JAX package on the same numpy inputs, on the CPU, where
the port's wrappers run their plain versions. The JAX side runs its Pallas
kernels in interpret mode and `bn_act_matmul_reference`, as
tests/test_fused_matmul_bn.py does. Sizes are small: a Bottleneck on the
JAX side, DeepLabV3+ with ResNet layers (1,1,1,1) at 65x65 in the port."""

import contextlib
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pytorch_segmentation_tpu.nn import blocks as jblocks
from pytorch_segmentation_tpu.nn.backbones.resnet import (
    Bottleneck as JaxBottleneck)
from pytorch_segmentation_tpu.ops.pallas import fused_matmul_bn as jfm
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.models import (build_model,
                                                   without_default_init)
from pytorch_segmentation_tpu_torch.nn import blocks as tblocks
from pytorch_segmentation_tpu_torch.nn.backbones.resnet import Bottleneck
from pytorch_segmentation_tpu_torch.ops.kernels import build
from pytorch_segmentation_tpu_torch.ops.kernels import cmajor_matmul as cm
from pytorch_segmentation_tpu_torch.ops.kernels import fused_matmul_bn as fm
from pytorch_segmentation_tpu_torch.utils.weights import (seeded_state_dict,
                                                          state_dict_from_jax)

torch.set_num_threads(1)

ACTS = ("relu", "relu6", "none")


@pytest.fixture(autouse=True)
def _switches_off():
    """Both packages' switches are process-wide: leave them off."""
    yield
    tblocks.set_force_fused_1x1(None)
    jblocks.set_force_fused_1x1(None)


def _data(n, k, m, seed=0):
    """x, scale, shift, w as the JAX package's own test makes them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            (0.5 + rng.random(k)).astype(np.float32),
            (0.2 * rng.standard_normal(k)).astype(np.float32),
            (rng.standard_normal((k, m)) * 0.1).astype(np.float32))


def _cotangents(n, m, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, m)).astype(np.float32),
            (rng.standard_normal(m) * 0.01).astype(np.float32),
            (rng.standard_normal(m) * 0.001).astype(np.float32))


def _torch(arrays, dtype=None, grad=False):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.array(a))
        if dtype is not None and t.dim() == 2:
            t = t.to(dtype)
        out.append(t.requires_grad_(grad))
    return out


# ------------------------------------------------------------ plain forward

@pytest.mark.parametrize("n,k,m,tn,act", [
    (512, 128, 256, 256, "relu"),    # aligned
    (300, 128, 128, 128, "relu"),    # ragged N
    (257, 64, 64, 128, "relu6"),     # narrow channels, ragged N
    (128, 256, 1024, 64, "none"),    # several column tiles on the JAX side
    (257, 64, 64, 128, "none"),
    (300, 128, 128, 128, "relu6"),
])
def test_plain_forward_matches_jax(n, k, m, tn, act):
    """f32: the port's plain forward against the Pallas kernel in interpret
    mode and against the JAX plain version, at the JAX test's shapes and
    tolerances (y 1e-4, sums 1e-3 absolute on top of 1e-4 relative)."""
    data = _data(n, k, m)
    y, s, ss = fm.bn_act_matmul_reference(*_torch(data), act=act)
    wrapped = fm.fused_bn_act_matmul(*_torch(data), act=act)
    for a, b in zip((y, s, ss), wrapped):  # a CPU tensor takes the plain one
        assert torch.equal(a, b)
    assert y.dtype == s.dtype == ss.dtype == torch.float32
    jdata = [jnp.asarray(a) for a in data]
    for want in (jfm.fused_bn_act_matmul(*jdata, tn=tn, interpret=True,
                                         act=act),
                 jfm.bn_act_matmul_reference(*jdata, act=act)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(ss.numpy(), np.asarray(want[2]),
                                   rtol=1e-4, atol=1e-3)


def test_plain_forward_matches_jax_bf16():
    """bf16 operands, f32 sums. Both sides round z where the other does, so
    y lands within one bf16 ulp (2^-7 relative) of the JAX y, with a floor
    of 1e-3 of the largest entry for entries near zero (XLA's CPU backend
    may keep the prologue's product unrounded, which moves single z entries
    by an ulp); the sums, taken before y is rounded, within 2e-3 of their
    largest entry."""
    data = _data(300, 128, 128)
    y, s, ss = fm.bn_act_matmul_reference(*_torch(data, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and s.dtype == ss.dtype == torch.float32
    jdata = [jnp.asarray(a, jnp.bfloat16 if a.ndim == 2 else jnp.float32)
             for a in data]
    for want in (jfm.fused_bn_act_matmul(*jdata, tn=128, interpret=True),
                 jfm.bn_act_matmul_reference(*jdata)):
        jy = np.asarray(want[0].astype(jnp.float32))
        diff = np.abs(y.float().numpy() - jy)
        assert (diff <= 2.0 ** -7 * np.abs(jy) + 1e-3 * np.abs(jy).max()
                ).all(), diff.max()
        for got, ref in ((s, want[1]), (ss, want[2])):
            ref = np.asarray(ref)
            assert np.abs(got.numpy() - ref).max() <= 2e-3 * np.abs(ref).max()


def test_y_is_rounded_from_the_f32_sums():
    """The statistics come from the f32 y, not from the bf16 output."""
    x, scale, shift, w = _torch(_data(256, 64, 64), torch.bfloat16)
    y, s, ss = fm.bn_act_matmul_reference(x, scale, shift, w)
    z = torch.relu(x * scale.bfloat16() + shift.bfloat16())
    y32 = z.float() @ w.float()
    assert torch.equal(y, y32.bfloat16())
    assert torch.equal(s, y32.sum(0)) and torch.equal(ss, (y32 * y32).sum(0))
    assert not torch.equal(s, y.float().sum(0))


def test_leading_dimensions_round_trip():
    """[B, H, W, K] is flattened inside and the leading shape restored."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    y, s, _ = fm.fused_bn_act_matmul(x, torch.ones(64), torch.zeros(64), w)
    assert y.shape == (2, 8, 8, 128) and s.shape == (128,)
    ref, rs, _ = fm.bn_act_matmul_reference(x.reshape(-1, 64), torch.ones(64),
                                            torch.zeros(64), w)
    assert torch.equal(y.reshape(-1, 128), ref) and torch.equal(s, rs)


# ---------------------------------------------------------------- gradients

def _loss(fn, cts):
    def f(x, scale, shift, w):
        y, s, ss = fn(x, scale, shift, w)
        return (y * cts[0]).sum() + (s * cts[1]).sum() + (ss * cts[2]).sum()
    return f


@pytest.mark.parametrize("act", ACTS)
def test_gradients_match_jax_and_autograd(act):
    """All four gradients of `fused_bn_act_matmul` on the CPU (the plain
    backward) through a loss that uses y AND both statistics: against
    `jax.grad` through the Pallas kernels in interpret mode, and against
    torch.autograd through the plain forward. f32, rtol/atol 1e-3 as the JAX
    package's test."""
    n, k, m = 192, 128, 256
    data, cts = _data(n, k, m), _cotangents(n, m)
    leaves = _torch(data, grad=True)
    got = torch.autograd.grad(
        _loss(functools.partial(fm.fused_bn_act_matmul, act=act),
              _torch(cts))(*leaves), leaves)
    leaves = _torch(data, grad=True)
    auto = torch.autograd.grad(
        _loss(functools.partial(fm.bn_act_matmul_reference, act=act),
              _torch(cts))(*leaves), leaves)

    jcts = [jnp.asarray(c) for c in cts]

    def jloss(x, scale, shift, w):
        y, s, ss = jfm.fused_bn_act_matmul(x, scale, shift, w, tn=64,
                                           interpret=True, act=act)
        return (jnp.sum(y * jcts[0]) + jnp.sum(s * jcts[1])
                + jnp.sum(ss * jcts[2]))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *[jnp.asarray(a) for a in data])
    for g, a, j, name in zip(got, auto, want,
                             ("dx", "dscale", "dshift", "dw")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=f"autograd {name}")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-3, err_msg=f"jax {name}")


@pytest.mark.parametrize("act", ACTS)
def test_gradcheck_f64(act):
    rng = np.random.default_rng(3)
    n, k, m = 40, 16, 8
    x = torch.tensor(rng.standard_normal((n, k)) * 2.0, requires_grad=True)
    scale = torch.tensor(0.5 + rng.random(k), requires_grad=True)
    shift = torch.tensor(0.2 * rng.standard_normal(k), requires_grad=True)
    w = torch.tensor(rng.standard_normal((k, m)) * 0.1, requires_grad=True)
    assert torch.autograd.gradcheck(
        functools.partial(fm.fused_bn_act_matmul, act=act),
        (x, scale, shift, w))


def test_backward_pieces_compose():
    """The dx and dW plain versions (one per kernel) are the plain backward;
    dy_tot is rounded to x's dtype before both products, and the mask comes
    from the f32 pre."""
    n, k, m = 96, 32, 24
    x, scale, shift, w = _torch(_data(n, k, m), torch.bfloat16)
    dy, dsum, dsumsq = _torch(_cotangents(n, m), torch.bfloat16)
    dx, dscale, dshift, dy_tot = fm.bn_act_matmul_dx_reference(
        x, scale, shift, w, dy, dsum, dsumsq)
    dw = fm.bn_act_matmul_dw_reference(x, scale, shift, dy_tot)
    whole = fm.bn_act_matmul_backward_reference(x, scale, shift, w, dy, dsum,
                                                dsumsq)
    for a, b in zip((dx, dscale, dshift, dw), whole):
        assert torch.equal(a, b)
    assert dx.dtype == dy_tot.dtype == torch.bfloat16
    assert dscale.dtype == dshift.dtype == dw.dtype == torch.float32
    mask = (x.float() * scale + shift) > 0
    assert not bool((dx[~mask] != 0).any())
    z = torch.relu(x * scale.bfloat16() + shift.bfloat16())
    assert torch.equal(dw, z.float().t() @ dy_tot.float())


# --------------------------------------------------------- wrapper contract

def test_cpu_wrapper_counts_no_launch_and_counts_copies():
    fm.reset_launch_count()
    fm.reset_layout_copy_count()
    x, scale, shift, w = _torch(_data(64, 16, 8), grad=True)
    out = fm.fused_bn_act_matmul(x, scale, shift, w)
    torch.autograd.grad(out[0].sum() + out[1].sum(), (x, scale, shift, w))
    assert fm.launch_count() == {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}
    assert fm.layout_copy_count() == 0
    # rows that are not contiguous (an NCHW activation seen as NHWC): one
    # counted copy, the same values
    nchw = torch.randn(2, 16, 4, 4)
    y, _, _ = fm.fused_bn_act_matmul(nchw.permute(0, 2, 3, 1), scale, shift, w)
    assert fm.layout_copy_count() == 1
    ref, _, _ = fm.fused_bn_act_matmul(
        nchw.permute(0, 2, 3, 1).contiguous(), scale, shift, w)
    assert torch.equal(y, ref) and fm.layout_copy_count() == 1
    # channels_last memory: the NHWC view has contiguous rows
    fm.fused_bn_act_matmul(
        nchw.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1),
        scale, shift, w)
    assert fm.layout_copy_count() == 1
    fm.reset_layout_copy_count()
    assert fm.layout_copy_count() == 0


@pytest.mark.parametrize("k,m,act,dtype,error", [
    (20, 8, "relu", torch.float32, ValueError),      # K not a multiple of 8
    (16, 12, "relu", torch.float32, ValueError),     # M not a multiple of 8
    (16, 8, "gelu", torch.float32, ValueError),      # unknown prologue
    (16, 8, "relu", torch.float16, TypeError),       # unsupported dtype
])
def test_wrapper_rejects(k, m, act, dtype, error):
    with pytest.raises(error):
        fm.fused_bn_act_matmul(torch.zeros(4, k, dtype=dtype), torch.ones(k),
                               torch.zeros(k), torch.zeros(k, m), act=act)


def test_wrapper_rejects_mismatched_shapes():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError):
        fm.fused_bn_act_matmul(x, torch.ones(8), torch.zeros(16),
                               torch.zeros(16, 8))
    with pytest.raises(ValueError):
        fm.fused_bn_act_matmul(x, torch.ones(16), torch.zeros(16),
                               torch.zeros(8, 8))
    with pytest.raises(ValueError):
        fm.fused_bn_act_matmul(torch.zeros(0, 16), torch.ones(16),
                               torch.zeros(16), torch.zeros(16, 8))


@pytest.mark.parametrize("n,k,m", [
    (532512, 64, 64), (532512, 256, 64), (532512, 64, 256),
    (135200, 512, 128), (135200, 512, 256), (34848, 1024, 256),
    (34848, 2048, 512), (34848, 512, 2048),
    (1237, 24, 144), (4133, 56, 72), (5, 8, 8), (1, 2048, 2048),
])
def test_dw_split_covers_the_rows(n, k, m):
    """The dW kernels' split of N: whole row steps, every row in exactly one
    split, no empty split, at least 256 rows a split; the Hopper kernel's
    (128 x 128 or 128 x 64 tile, split) blocks fit one wave of two blocks on
    132 SMs and fill at least 90% of it where N has the rows; partials that
    stay small."""
    splits, rows = fm.dw_split(n, k, m)
    assert splits >= 1 and rows % 64 == 0
    assert (splits - 1) * rows < n <= splits * rows
    assert splits == 1 or rows >= 256
    tiles = -(-k // 128) * -(-m // fm.wgmma_tiles(k, m)["dw"])
    assert splits * tiles <= max(264, tiles)
    if n >= 264 * 256:
        assert splits * tiles >= 0.9 * (264 // tiles) * tiles
    assert splits * k * m * 4 <= 32 << 20


# the channel widths of the R50 step's 12 shapes
# (tools/bench_fused_matmul.SHAPES) and the ragged MobileNetV2 widths
@pytest.mark.parametrize("k,m", [
    (64, 64), (64, 256), (256, 64), (256, 128), (128, 512), (512, 128),
    (512, 256), (256, 1024), (1024, 256), (1024, 512), (512, 2048),
    (2048, 512), (24, 144), (144, 24)])
def test_wgmma_tiles_by_shape(k, m):
    """The Hopper kernels' column tiles are 64 wide over a matrix 64 wide
    or less, else 128: the forward's, dx's first grid's and dW's over M,
    dx's second grid's over K."""
    assert fm.wgmma_tiles(k, m) == {"fwd": 64 if m <= 64 else 128,
                                    "dx_dy_tot": 64 if m <= 64 else 128,
                                    "dx_dz": 64 if k <= 64 else 128,
                                    "dw": 64 if m <= 64 else 128}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launchers_choose_the_loop_by_dtype(dtype, monkeypatch):
    """bf16 goes to the Hopper entry points (W^T for the forward, W and W^T
    for dx, the `wgmma_tiles` widths, dW with its M tile and `dw_split`),
    f32 to the older loop's (W; dW with the same split); each launcher
    counts one launch, and a refused TMA descriptor raises. The library and
    the stream are stand-ins: nothing is built here."""
    calls = []

    def entry(name, err=0):
        def fn(*args):
            calls.append((name, args))
            return err
        return fn

    fns = {name: entry(name) for name in ("fwd", "bwd_dx", "bwd_dw",
                                          "fwd_wgmma", "dx_wgmma",
                                          "dw_wgmma", "smem")}
    monkeypatch.setattr(fm, "_kernel_fns", lambda: fns)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    n, k, m = 300, 56, 264
    x, dy = torch.zeros(n, k, dtype=dtype), torch.zeros(n, m, dtype=dtype)
    vec, wc = torch.zeros(k), torch.zeros(k, m, dtype=dtype)
    wt = wc.t().contiguous()
    before = fm.launch_count()
    y, s, ss = fm._launch_fwd(x, vec, vec, wc, "relu6", wt)
    dx, dsc, dsh, dy_tot = fm._launch_bwd_dx(x, vec, vec, wc, dy,
                                             torch.zeros(m), torch.zeros(m),
                                             "relu6", wt)
    dw = fm._launch_bwd_dw(x, vec, vec, dy_tot, "relu6")
    after = fm.launch_count()
    assert {key: after[key] - before[key] for key in after} == {
        "fwd": 1, "bwd_dx": 1, "bwd_dw": 1}
    assert (y.shape, s.shape, dx.shape, dsc.shape, dy_tot.shape) == (
        (n, m), (m,), (n, k), (k,), (n, m))
    assert dw.shape == (k, m) and dw.dtype == torch.float32
    (fwd_name, fwd_args), (dx_name, dx_args), (dw_name, dw_args) = calls
    assert fm.dw_split(n, k, m) == (2, 192)
    assert dw_args[:4] == (x.data_ptr(), vec.data_ptr(), vec.data_ptr(),
                           dy_tot.data_ptr())
    if dtype == torch.bfloat16:
        assert (fwd_name, dx_name, dw_name) == ("fwd_wgmma", "dx_wgmma",
                                                "dw_wgmma")
        assert fwd_args[3] == wt.data_ptr()
        assert fwd_args[6:] == (2, n, k, m, 128, 7)
        assert dx_args[3:5] == (wc.data_ptr(), wt.data_ptr())
        assert dx_args[11:] == (2, n, k, m, 128, 64, 7)
        assert dw_args[5:] == (2, n, k, m, 128, 2, 192, 7)
        for name, launch in (
                ("fwd_wgmma", lambda: fm._launch_fwd(x, vec, vec, wc,
                                                     "relu6", wt)),
                ("dw_wgmma", lambda: fm._launch_bwd_dw(x, vec, vec, dy_tot,
                                                       "relu6"))):
            fns[name] = entry(name, 10001)
            with pytest.raises(RuntimeError, match="TMA descriptor"):
                launch()
    else:
        assert (fwd_name, dx_name, dw_name) == ("fwd", "bwd_dx", "bwd_dw")
        assert fwd_args[3] == wc.data_ptr()
        assert fwd_args[6:] == (2, n, k, m, 7)
        assert dx_args[3] == wc.data_ptr()
        assert dx_args[10:] == (2, n, k, m, 7)
        assert dw_args[5:] == (2, n, k, m, 2, 192, 7)


# ------------------------------------------------------------ BatchNorm fold

def _fold_pair(c, rng):
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    tbn = tblocks.BatchNorm2d(c, dtype=torch.float32)
    tbn.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean),
        "running_var": torch.from_numpy(var),
        "num_batches_tracked": torch.zeros((), dtype=torch.int64)})
    return jblocks.BatchNormFolded(), variables, tbn


def test_batchnorm_fold_matches_jax():
    """`BatchNorm2d.fold` against `BatchNormFolded` from the same sums:
    train mode (scale, shift, the running update with the unbiased variance,
    gradients through the sums) and eval mode (the running statistics)."""
    rng = np.random.default_rng(0)
    c, n = 8, 150
    jbn, variables, tbn = _fold_pair(c, rng)
    y = (2.0 * rng.standard_normal((n, c)) + 0.5).astype(np.float32)
    s, ss = y.sum(0), (y * y).sum(0)
    r = rng.standard_normal((2, c)).astype(np.float32)

    def jloss(s, ss):
        (inv, shift), mut = jbn.apply(variables, s, ss, n,
                                      use_running_average=False,
                                      mutable=["batch_stats"])
        return jnp.sum(inv * r[0]) + jnp.sum(shift * r[1]), (inv, shift, mut)

    (_, (jinv, jshift, mut)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(s),
                                              jnp.asarray(ss))
    ts, tss = _torch((s, ss), grad=True)
    inv, shift = tbn.train().fold(ts, tss, n)
    grads = torch.autograd.grad(
        (inv * torch.from_numpy(r[0])).sum()
        + (shift * torch.from_numpy(r[1])).sum(), (ts, tss))
    assert inv.dtype == shift.dtype == torch.float32
    np.testing.assert_allclose(inv.detach().numpy(), np.asarray(jinv),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(shift.detach().numpy(), np.asarray(jshift),
                               rtol=1e-5, atol=1e-6)
    for g, j in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-7)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6)
    assert int(tbn.num_batches_tracked) == 1

    jinv, jshift = jbn.apply(variables, jnp.asarray(s), jnp.asarray(ss), n,
                             use_running_average=True)
    jbn2, _, tbn2 = _fold_pair(c, np.random.default_rng(0))
    inv, shift = tbn2.eval().fold(torch.from_numpy(s), torch.from_numpy(ss), n)
    np.testing.assert_allclose(inv.detach().numpy(), np.asarray(jinv),
                               rtol=1e-6)
    np.testing.assert_allclose(shift.detach().numpy(), np.asarray(jshift),
                               rtol=1e-6, atol=1e-7)
    assert int(tbn2.num_batches_tracked) == 0


def test_fold_is_forward_without_the_apply():
    """`forward` is `fold` of the input's own sums, applied: one set of
    parameters, buffers and running updates for both paths."""
    rng = np.random.default_rng(1)
    _, _, a = _fold_pair(6, rng)
    _, _, b = _fold_pair(6, np.random.default_rng(1))
    x = torch.from_numpy(rng.standard_normal((3, 6, 5, 7)).astype(np.float32))
    y = a.train()(x)
    inv, shift = b.train().fold(x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)),
                                3 * 5 * 7)
    np.testing.assert_allclose(
        y.detach().numpy(),
        tblocks.apply_fold(x, inv, shift, torch.float32).detach().numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.running_var.numpy(), b.running_var.numpy(),
                               rtol=1e-6)


# ------------------------------------------------------------------ switch

def test_switch_modes():
    assert not tblocks.fused_1x1_available()       # off by default
    tblocks.set_force_fused_1x1("on")
    assert tblocks.fused_1x1_available()
    tblocks.set_force_fused_1x1("off")
    assert not tblocks.fused_1x1_available()
    tblocks.set_force_fused_1x1("on")
    tblocks.set_force_fused_1x1(None)
    assert not tblocks.fused_1x1_available()
    for mode in ("interpret", True, "auto"):
        with pytest.raises(ValueError):
            tblocks.set_force_fused_1x1(mode)
    assert not tblocks.fused_1x1_available()


# --------------------------------------------------------------- Bottleneck

def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _bottleneck_pair():
    """A JAX Bottleneck's variables, initialised under 'interpret', carried
    into the port's Bottleneck by `state_dict_from_jax`; the post-ReLU input
    both see (NHWC numpy)."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal((2, 8, 8, 32)), 0).astype(np.float32)
    jm = JaxBottleneck(16, stride=1, downsample=True, dtype=jnp.float32)
    jblocks.set_force_fused_1x1("interpret")
    # jitted: one compile of the interpreted kernels instead of one per op
    variables = jax.jit(lambda key, v: jm.init(key, v, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    params = _numpy_tree(variables["params"])
    stats = _numpy_tree(variables["batch_stats"])
    tm = Bottleneck(32, 16, downsample=True, dtype=torch.float32)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        state_dict_from_jax(params, stats).items()})
    return jm, params, stats, tm, x


def _port_bottleneck_train(tm, x):
    """Output, parameter gradients of sum(y^2) and the buffers after one
    train-mode call of a copy of `tm` (NHWC numpy in and out)."""
    import copy
    tm = copy.deepcopy(tm).train()
    y = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad((y ** 2).sum(), list(tm.parameters()))
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            dict(zip(names, (g.numpy() for g in grads))),
            {k: v.numpy() for k, v in tm.state_dict().items()})


def test_fused_bottleneck_matches_jax():
    """The port's Bottleneck with the switch on against the JAX Bottleneck
    under 'interpret' on the same variables, f32: eval output, train output,
    running statistics and parameter gradients, at the tolerances of the JAX
    package's `test_fused_bottleneck_matches_plain_path`."""
    jm, params, stats, tm, x = _bottleneck_pair()
    tblocks.set_force_fused_1x1("on")
    fm.reset_launch_count()

    jy = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        ty = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)

    def loss_fn(p):
        y, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y ** 2), (y, mut["batch_stats"])

    (_, (jy, jstats)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    ty, tgrads, tstate = _port_bottleneck_train(tm, x)
    np.testing.assert_allclose(ty, np.asarray(jy), rtol=1e-4, atol=1e-4)
    want = state_dict_from_jax(_numpy_tree(jgrads), {})
    assert sorted(want) == sorted(tgrads)
    for name, g in want.items():
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-3, atol=1e-3,
                                   err_msg=name)
    for name, v in state_dict_from_jax({}, _numpy_tree(jstats)).items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(tstate[name], v, rtol=1e-3, atol=1e-4,
                                       err_msg=name)
    assert fm.launch_count() == {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}


def test_fused_bottleneck_matches_plain_path():
    """Switch on against switch off inside the port, same module and
    state_dict: outputs, gradients, buffers (f32: the two paths differ only
    in summation order)."""
    _, _, _, tm, x = _bottleneck_pair()
    tblocks.set_force_fused_1x1("off")
    off = _port_bottleneck_train(tm, x)
    with torch.no_grad():
        eval_off = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    tblocks.set_force_fused_1x1("on")
    on = _port_bottleneck_train(tm, x)
    with torch.no_grad():
        eval_on = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(eval_on.numpy(), eval_off.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(on[0], off[0], rtol=1e-4, atol=1e-4)
    assert list(on[1]) == list(off[1]) and list(on[2]) == list(off[2])
    for name in off[1]:
        np.testing.assert_allclose(on[1][name], off[1][name], rtol=1e-3,
                                   atol=1e-3, err_msg=name)
    for name in off[2]:
        np.testing.assert_allclose(on[2][name], off[2][name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert int(on[2]["conv1.bn.num_batches_tracked"]) == 1
    # the unit fold of conv1's prologue is no part of the state_dict
    assert not any("unit" in name for name in tm.state_dict())


def test_folded_route_of_a_strided_3x3():
    """`ConvNormAct.folded` on anything but a 1x1 stride-1 convolution is
    the explicit route: BN-apply + activation, the convolution, the sums."""
    rng = np.random.default_rng(2)
    block = tblocks.ConvNormAct(8, 16, 3, stride=2, dtype=torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, 8, 9, 9)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.standard_normal(8)).astype(np.float32))
    fm.reset_layout_copy_count()
    for act, fn in (("relu", torch.relu), ("relu6", lambda t: t.clamp(0, 6)),
                    ("none", lambda t: t)):
        y_raw, out_scale, out_shift = block.train().folded(x, scale, shift,
                                                           act)
        z = fn(x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1))
        want = block.conv(z)
        np.testing.assert_allclose(y_raw.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert y_raw.shape == (2, 16, 5, 5)
        var = want.var(dim=(0, 2, 3), unbiased=False)
        np.testing.assert_allclose(
            out_scale.detach().numpy(),
            (block.bn.weight / torch.sqrt(var + 1e-5)).detach().numpy(),
            rtol=1e-4)
    with pytest.raises(ValueError):
        block.folded(x, scale, shift, "gelu")
    assert fm.layout_copy_count() == 0


# ------------------------------------------------------- the slice as a whole

def _small_model():
    return build_model("deeplabv3plus", 5, backbone_layers=(1, 1, 1, 1),
                       dtype=torch.float32, full_res_output=True)


def test_trainer_steps_with_the_switch_on_match_off(tmp_path):
    """DeepLabV3+ (f32, ResNet layers (1,1,1,1), 2x65x65) from
    `seeded_state_dict(init="uniform")` at lr 1e-3: 3 `Trainer(device="cpu")`
    steps with the switch on against off. The two paths sum the same
    products in another order, so losses agree to 1e-4 relative and the
    final tensors to 2e-3 of each tensor's largest entry (the bound the
    repo's small-model train checks use: the updates of convolutions that
    feed a BatchNorm over a few dozen values are sums that cancel)."""
    rng = np.random.default_rng(3)
    batch = (rng.standard_normal((2, 65, 65, 3)).astype(np.float32),
             rng.integers(0, 5, (2, 65, 65)).astype(np.int32), 2)
    start = str(tmp_path / "start.pt")
    with without_default_init():   # seeded, then loaded by the Trainer
        torch.save({"model": seeded_state_dict(_small_model(), 0,
                                               init="uniform")}, start)

    def run(mode):
        tblocks.set_force_fused_1x1(mode)
        with without_default_init():
            model = _small_model()
        trainer = Trainer(model, [batch], lr=1e-3, momentum=0.9,
                          weights=start, log=False,
                          log_dir=str(tmp_path / f"runs_{mode}"),
                          device="cpu")
        losses = [trainer.step() for _ in range(3)]
        return losses, {k: v.detach().clone()
                        for k, v in model.state_dict().items()}

    fm.reset_launch_count()
    fm.reset_layout_copy_count()
    off_losses, off_sd = run("off")
    on_losses, on_sd = run("on")
    assert fm.launch_count() == {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}
    assert fm.layout_copy_count() == 0     # the model lives in channels_last
    assert list(on_sd) == list(off_sd)
    assert all(np.isfinite(on_losses))
    for a, b in zip(on_losses, off_losses):
        assert abs(a - b) <= 1e-4 * abs(b), (on_losses, off_losses)
    for name, want in off_sd.items():
        if want.dtype.is_floating_point:
            err = float((on_sd[name] - want).abs().max())
            assert err <= 2e-3 * float(want.abs().max()), (name, err)
        else:
            assert torch.equal(on_sd[name], want), name
    moved = off_sd["backbone.layer1_block0.conv1.bn.running_mean"]
    assert int(on_sd["backbone.layer1_block0.conv1.bn.num_batches_tracked"]
               ) == 3 and float(moved.abs().max()) > 0


def test_eval_twin_takes_the_folded_chain():
    """The switch is read at forward time, so a shallow copy of the model
    (the Trainer's and `test()`'s stride-4 twin) runs the folded chain too:
    every Bottleneck's conv1 and conv3 call the fused function."""
    import copy
    model = _small_model().eval()
    twin = copy.copy(model)
    twin.full_res_output = False
    x = torch.randn(1, 3, 65, 65)
    calls = []
    real = tblocks.fused_bn_act_matmul

    def counting(*args, **kwargs):
        calls.append(kwargs.get("act"))
        return real(*args, **kwargs)

    tblocks.fused_bn_act_matmul = counting
    try:
        with torch.no_grad():
            off = twin(x)
            assert calls == []
            tblocks.set_force_fused_1x1("on")
            on = twin(x)
    finally:
        tblocks.fused_bn_act_matmul = real
    assert calls == ["relu"] * 8         # 4 bottlenecks x (conv1, conv3)
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ channels-major

def _jax_bench_cmajor():
    path = Path(__file__).resolve().parents[1] / "tools" / "bench_cmajor.py"
    spec = importlib.util.spec_from_file_location("jax_bench_cmajor", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cmajor_reference_matches_jax_kernel():
    """`cmajor_matmul_reference` against the benchmark tool's `_mm_kernel`
    in interpret mode: bf16 operands, f32 sums and f32 output on both sides
    (the products are exact in f32, so only the summation order differs)."""
    rng = np.random.default_rng(0)
    co, ci, pix, tn = 16, 24, 256, 128
    w = rng.standard_normal((co, ci)).astype(np.float32)
    x = rng.standard_normal((ci, pix)).astype(np.float32)
    kernel = _jax_bench_cmajor()._mm_kernel
    want = pl.pallas_call(
        kernel, grid=(pix // tn,),
        in_specs=[pl.BlockSpec((co, ci), lambda i: (0, 0)),
                  pl.BlockSpec((ci, tn), lambda i: (0, i))],
        out_specs=pl.BlockSpec((co, tn), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((co, pix), jnp.float32),
        interpret=True)(jnp.asarray(w, jnp.bfloat16),
                        jnp.asarray(x, jnp.bfloat16))
    tw, tx = torch.from_numpy(w).bfloat16(), torch.from_numpy(x).bfloat16()
    got = cm.cmajor_matmul_reference(tw, tx)
    assert got.dtype == torch.float32 and got.shape == (co, pix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    cm.reset_launch_count()
    assert torch.equal(cm.cmajor_matmul(tw, tx), got)   # CPU: the plain one
    assert cm.launch_count() == 0


@pytest.mark.parametrize("w_shape,x_shape,dtype,error", [
    ((8, 16), (24, 64), torch.bfloat16, ValueError),   # ci mismatch
    ((8, 12), (12, 64), torch.bfloat16, ValueError),   # ci not a multiple of 8
    ((8, 16), (16, 60), torch.bfloat16, ValueError),   # pix not a multiple of 8
    ((8, 16), (16, 64), torch.float32, TypeError),     # f32 operands
])
def test_cmajor_rejects(w_shape, x_shape, dtype, error):
    with pytest.raises(error):
        cm.cmajor_matmul(torch.zeros(w_shape, dtype=dtype),
                         torch.zeros(x_shape, dtype=dtype))


@pytest.mark.parametrize("a_shape,b_shape,dtype", [
    ((16, 24), (24, 32), torch.bfloat16),   # on the CPU: no kernel there
    ((16, 24), (24, 32), torch.float32),    # f32 operands
    ((16, 24), (16, 32), torch.bfloat16),   # depths differ
])
def test_wgmma_product_rejects_before_the_kernel(a_shape, b_shape, dtype):
    """The layout test's product checks its operands before any pointer
    reaches the library (nothing is built here)."""
    with pytest.raises(ValueError):
        cm.wgmma_product(torch.zeros(a_shape, dtype=dtype),
                         torch.zeros(b_shape, dtype=dtype), False, True)


# ------------------------------------------------------------------- build

def test_new_kernel_source_has_a_plain_c_interface():
    """Both new wrappers load `csrc/fused_matmul_bn.cu`, a source with a
    plain C interface like the others: no PyTorch header, the f32 loop's
    three entry points and the Hopper loop's five, every bf16 product on
    `wgmma` (the older `wmma` loop is gone), no atomics."""
    src = (build.CSRC_DIR / "fused_matmul_bn.cu").read_text()
    assert "torch/" not in src and "ATen" not in src
    for name in ("pseg_fused_matmul_bn_fwd", "pseg_fused_matmul_bn_bwd_dx",
                 "pseg_fused_matmul_bn_bwd_dw", "pseg_cmajor_matmul"):
        assert f'extern "C" int {name}(' in src
    for name in ("pseg_fused_matmul_bn_fwd_wgmma",
                 "pseg_fused_matmul_bn_bwd_dx_wgmma",
                 "pseg_fused_matmul_bn_bwd_dw_wgmma", "pseg_wgmma_product"):
        assert f'extern "C" int {name}(' in src
    assert "wmma::" not in src and "atomicAdd" not in src
    for kernel in ("dw_wgmma_kernel", "cmajor_wgmma_kernel"):
        assert f"{kernel}(" in src, kernel
    # the Hopper loop: TMA into an mbarrier ring, wgmma from shared memory
    for op in ("cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
               "wgmma.mma_async", "cuTensorMapEncodeTiled"):
        assert op in src, op
    assert "-lcuda" in build.LINK_FLAGS
