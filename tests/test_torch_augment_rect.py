"""PyTorch port: the augmentation options beyond the square two-pass warp
(data/augment.py) against the JAX package on the CPU: non-square frames
through the gather samplers and the rectangular filter, `banded_warp=False`,
`separable_warp=True`, `fast_geometric=True` and `per_sample_photo_order`.
As in tests/test_torch_augment.py, the JAX functions that draw run eagerly
under a tape of `jax.random`'s samplers, and the port's apply half takes
the recorded values."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.data import augment as jaug
from pytorch_segmentation_tpu.data import pipeline as jpipe
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.data import augment as taug
from pytorch_segmentation_tpu_torch.data.loader import Batch
from pytorch_segmentation_tpu_torch.data.pipeline import PostFetch
from pytorch_segmentation_tpu_torch.models.deeplabv3plus import DeepLabV3Plus
from pytorch_segmentation_tpu_torch.utils.synthetic import make_synthetic_coco
from torch_augment_util import (OP_NAMES, PACKED_NAMES, jax_geometry,
                                jax_pool, pool_images, run_jax_op,
                                stack_draws, tape, to_np, to_t, warp_inputs)

torch.set_num_threads(1)


def _port_names(names):
    """The port's geometry keys in draw order for JAX draw names: the three
    Sometimes bits come first, as one [B, 3] draw."""
    return ["sometimes"] + [n for n in names if not n.startswith("some")]


def _assert_draws_alike(cfg, b, h, w, want):
    """The port draws the values of `want` (a parameter dict from the JAX
    tape) under the same names, in the JAX package's call order, with the
    same shapes and dtypes."""
    got = taug._draw_geometry(torch.Generator().manual_seed(0), cfg, b, h, w)
    assert list(got) == list(want)
    for k, v in got.items():
        assert (v.shape, v.dtype) == (want[k].shape, want[k].dtype), k


# ---------------------------------------------------------------------------
# the gather samplers' coordinates and the samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [None, 0, 1])
def test_geometric_coords_match_jax_under_the_same_draws(tape, order):
    """`_geometric_coords` from JAX's draws: the homography and the
    displacement field within 1e-4 px, as the two-pass fields are held;
    mode, cval, order and the dithers exact."""
    h, w = (40, 24) if order == 0 else (24, 40)
    kw = dict(p_sometimes=0.9, p_affine=0.8, image_warp_order=order)
    b = 3
    keys = jax.random.split(jax.random.PRNGKey(10 + (order or 0)), b)
    gates = np.random.default_rng(order or 0).random((b, 16)) < 0.6
    names = PACKED_NAMES if order is None else PACKED_NAMES[:-3]
    want, geo = jax_geometry(tape, jaug._geometric_coords,
                             jaug.AugmentConfig(**kw), keys, gates, h, w,
                             names)
    tcfg = taug.AugmentConfig(**kw)
    geo = {k: geo[k] for k in _port_names(names)}
    _assert_draws_alike(tcfg, b, h, w, geo)
    got = taug._geometric_coords(geo, to_t(gates), tcfg, h, w)
    for k in (2, 3, 4):                       # mode, cval, order
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for g, v in zip(got[5:], want[5:]):       # the dithers
        assert (g is None) == (v is None) == (order is not None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), v)
    for g, v in zip(got[:2], want[:2]):       # sy, sx
        assert g.shape == (b, h, w)
        np.testing.assert_allclose(g.numpy(), v, rtol=0, atol=1e-4)


def _sampler_inputs(h, w, b=4):
    """u8 images, labels up to 255 and coordinates reaching past every edge,
    some on exact half-pixel ties."""
    rng = np.random.default_rng(h * w)
    imgs = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    segs = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sy, sx = [], []
    for s in range(b):
        th = 0.4 * s - 0.5
        y = np.cos(th) * (yy - h / 2) + np.sin(th) * (xx - w / 2)
        x = -np.sin(th) * (yy - h / 2) + np.cos(th) * (xx - w / 2)
        sy.append(1.2 * y + h / 2 + rng.uniform(-1, 1, (h, w)))
        sx.append(1.2 * x + w / 2 + rng.uniform(-1, 1, (h, w)))
    sy, sx = np.stack(sy).astype(np.float32), np.stack(sx).astype(np.float32)
    sx[:, 0, :] = np.arange(w) - 2.5          # ties, and -0.5 exactly
    sy[:, :, 0] = np.arange(h) * 0.5 - 0.5
    mode = np.array([0, 1, 2, 3], np.int32)
    cval = np.array([3.5, 250.0, 0.0, 99.0], np.float32)
    return imgs, segs, sy, sx, mode, cval


@pytest.mark.parametrize("hw", [(24, 40), (40, 24)])
def test_packed_samplers_match_jax(hw):
    """One tap (plain nearest, and the stochastic tap with its dither) and
    four taps, in all 4 boundary modes: labels (bytes above 127 too) and
    nearest or stochastic images exact; the 4-tap bilinear image within
    1e-3 on the 0..255 scale."""
    imgs, segs, sy, sx, mode, cval = _sampler_inputs(*hw)
    rng = np.random.default_rng(1)
    ub = np.array([True, False, True, True])
    dy, dx = (np.where(ub[:, None, None], rng.random((2, 4) + hw) - 0.5, 0.0)
              .astype(np.float32))
    j = list(map(jnp.asarray, (imgs, segs, sy, sx, mode, cval)))
    t = [*map(to_t, (imgs, segs, sy, sx)), to_t(mode).long(), to_t(cval)]
    for dither in ((), (dy, dx)):
        w_img, w_seg = jax.jit(jaug._sample_nearest_packed)(
            *j, *map(jnp.asarray, dither))
        g_img, g_seg = taug._sample_nearest_packed(*t, *map(to_t, dither))
        np.testing.assert_array_equal(g_seg.numpy(), to_np(w_seg))
        np.testing.assert_array_equal(g_img.numpy(), to_np(w_img))
    assert set(np.unique(g_seg.numpy())) - {0} and g_seg.max() > 127
    w_img, w_seg = jax.jit(jaug._sample_packed)(*j, jnp.asarray(ub))
    g_img, g_seg = taug._sample_packed(*t, to_t(ub))
    assert g_img.dtype == torch.float32 and g_seg.dtype == torch.int32
    np.testing.assert_array_equal(g_seg.numpy(), to_np(w_seg))
    np.testing.assert_array_equal(g_img[1].numpy(), to_np(w_img)[1])
    np.testing.assert_allclose(g_img.numpy(), to_np(w_img), rtol=0,
                               atol=1e-3)


def test_sample_two_pass_matches_jax():
    """`separable_warp`'s lane-gather sampler on fixed fields, 4 boundary
    modes, bilinear and nearest samples: labels exact. The first pass's
    intermediate is requantised by truncating rgb + 0.5; both sides compute
    rgb as the same two products and sum, so the images come out equal
    (measured: 0 elements apart). The bound allows 0.1% of the elements to
    differ where the f32 sum sits at a .5 boundary that another rounding of
    a product would cross, by one count times the second pass's weight."""
    imgs, segs, vt, sx, sy, tf = warp_inputs()
    segs = segs * 12                          # labels up to 240
    mode = np.array([0, 1, 2, 3], np.int32)
    cval = np.array([7.25, 200.5, 0.0, 99.0], np.float32)
    ub = np.array([True, False, True, True])
    want_img, want_seg = jaug._sample_two_pass(
        *map(jnp.asarray, (imgs, segs, vt, sx, sy, mode, cval, ub, tf)))
    got_img, got_seg = taug._sample_two_pass(
        *map(to_t, (imgs, segs, vt, sx, sy)), to_t(mode).long(), to_t(cval),
        to_t(ub), to_t(tf))
    np.testing.assert_array_equal(got_seg.numpy(), to_np(want_seg))
    diff = np.abs(got_img.numpy() - to_np(want_img))
    assert (diff > 0).mean() <= 1e-3 and diff.max() <= 1.0, (
        (diff > 0).sum(), diff.max())


# ---------------------------------------------------------------------------
# the pool on rectangular frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(13), ids=OP_NAMES)
def test_photo_op_matches_jax_bf16_pool_nonsquare(tape, i):
    """The 13 ops on 24x40 frames (the shape of the policy tests below,
    whose JAX draws then compile once) in the default bf16 pool, under
    test_photo_op_matches_jax_bf16_pool's bound: f32 outputs within 1e-3,
    after the u8 requantisation at most 0.1% of the elements one count
    apart. Blur, sharpen and edge-blend take the rectangular filter here,
    the JAX package's depthwise convolutions."""
    x = pool_images(200 + i, 2, 24, 40)
    want, params = run_jax_op(tape, i, x, jaug.AugmentConfig(), seed=11)
    got = taug._PHOTO_OPS[i][1](params, to_t(x), taug.AugmentConfig())
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    diff = np.abs(np.clip(np.round(got.numpy()), 0, 255)
                  - np.clip(np.round(want), 0, 255))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.001, (
        OP_NAMES[i], diff.max(), (diff > 0).mean())


def test_rect_filter_takes_each_kernels_own_length():
    """Two kernels of different lengths on a frame taller than wide (the
    JAX fallback tiles the W kernel with the H kernel's length): the filter
    equals the two 1-D convolutions with edge padding, in numpy."""
    x = pool_images(3, 1, 20, 12)
    kh = np.array([1.0, 2.0, 1.0], np.float32)
    kw = np.array([1.0, 0.0, -2.0, 0.0, 1.0], np.float32)
    got = taug._sep_filter(to_t(x), to_t(kh)[None], to_t(kw)[None]).numpy()
    pad = np.pad(x[0], ((1, 1), (2, 2), (0, 0)), mode="edge")
    rows = sum(kh[t] * pad[t:t + 20] for t in range(3))
    want = sum(kw[t] * rows[:, t:t + 12] for t in range(5))
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# fast_geometric and per_sample_photo_order
# ---------------------------------------------------------------------------

def _fast_names(square):
    names = ["flip_lr", "flip_ud"] + (["do_rot", "quarter"] if square else [])
    return names + [f"{axis}_{n}" for axis in ("y", "x")
                    for n in ("do_cap", "side", "do_aff", "scale", "trans")]


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_fast_geometric_matches_jax(tape, hw):
    """`_fast_geometric_one` per sample under the same draws: flips, the
    quarter turns (square frames: every turn occurs in the batch), the
    per-axis interpolation products. Images within 1e-3, labels exact.
    Eager on the JAX side: compiled, its source coordinates move by an ulp
    (a fused multiply-add), and a weight times 255 by up to 1.7e-3."""
    h, w = hw
    kw = dict(fast_geometric=True, p_fliplr=0.5, p_flipud=0.5, p_affine=0.8,
              p_crop_pad=0.6)
    cfg = jaug.AugmentConfig(**kw)
    b = 6
    rng = np.random.default_rng(h)
    imgs = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    segs = rng.integers(0, 200, (b, h, w), dtype=np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(4), b)
    outs, tapes = [], []
    tape.take()
    for k, img, seg in zip(keys, imgs, segs):
        outs.append(jaug._fast_geometric_one(
            k, jnp.asarray(img, jnp.float32), jnp.asarray(seg, jnp.int32),
            cfg))
        tapes.append(tape.take())
    want_img, want_seg = (np.stack([to_np(o[k]) for o in outs])
                          for k in (0, 1))
    geo = stack_draws(tapes, _fast_names(h == w), {"quarter": torch.int64})
    tcfg = taug.AugmentConfig(**kw)
    _assert_draws_alike(tcfg, b, h, w, geo)
    if h == w:
        turns = torch.where(geo["do_rot"], geo["quarter"], 0)
        assert set(turns.tolist()) == {0, 1, 2, 3}
    got_img, got_seg = taug._fast_geometric(geo, to_t(imgs), to_t(segs))
    np.testing.assert_array_equal(got_seg.numpy(), want_seg)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=0, atol=1e-3)


def test_per_sample_photo_order_matches_jax(tape):
    """`per_sample_photo_order=True` against the JAX ops composed as its
    per-sample scan composes them (`_photometric_batch`: each sample's own
    permutation from `fold_in(k, 977)`, each op's draws from `fold_in(k,
    100 + i)`, u8 carry), eagerly: compiled, the JAX ops keep some bf16
    intermediates in f32 and round apart from their eager selves (measured:
    sharpen on 22% of the elements, by up to 5 counts), so the eager ops
    are the reference, as for the per-batch order. Exact but for a value at
    a rounding tie: at most 0.1% of the elements differ."""
    b, h, w = 3, 24, 40
    cfg = jaug.AugmentConfig(per_sample_photo_order=True)
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    gates = np.random.default_rng(5).random((b, 16)) < 0.5
    gates[:, 1] = gates[:, 4] = True           # blur and edge-blend always
    orders = [[int(v) for v in jax.random.permutation(
        jax.random.fold_in(k, 977), 13)] for k in keys]
    assert len({tuple(o) for o in orders}) == b
    x = pool_images(5, b, h, w)
    want, photo = jax_pool(tape, cfg, keys, x, gates, orders)
    tcfg = taug.AugmentConfig(per_sample_photo_order=True)
    got = taug._photometric_batch(orders, photo, to_t(x), to_t(gates),
                                  tcfg).numpy()
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 0.001, ((diff > 0).mean(), diff.max())
    # the batch under the first sample's order comes out otherwise
    one = taug._photometric_batch(orders[0], photo, to_t(x), to_t(gates),
                                  taug.AugmentConfig()).numpy()
    assert np.array_equal(one[0], got[0]) and not np.array_equal(one, got)


# ---------------------------------------------------------------------------
# the policy on a non-square batch under one fixed set of parameters
# ---------------------------------------------------------------------------

def test_nonsquare_slice_matches_jax_under_fixed_parameters(tape):
    """u8 batch in, normalized bf16 images and int32 labels out, at 24x40.
    JAX side: `_geometric_coords` + `_sample_nearest_packed` (the stochastic
    tap) + the ops in one order with the u8 carry + `normalize_images`; the
    port: `AugmentFn.apply` inside `PostFetch`, as
    test_slice_matches_jax_under_fixed_parameters holds the square policy,
    under its bounds: labels equal but for a coordinate at a rounding
    boundary (at most 0.1%), normalized images at most 1% of the elements
    apart, by at most 0.15, mean at most 1e-3."""
    b, h, w = 3, 24, 40
    imgs = pool_images(6, b, h, w).astype(np.uint8)
    segs = np.zeros((b, h, w), np.uint8)
    segs[:, 4:18, 5:25] = 3
    segs[:, 12:22, 18:38] = 150
    cfg, tcfg = jaug.AugmentConfig(), taug.AugmentConfig()
    keys = jax.random.split(jax.random.PRNGKey(6), b)
    gates = np.zeros((b, 16), bool)
    gates[0, [1, 5, 9, 13]] = True
    gates[1, [2, 4, 10, 14, 15]] = True
    gates[2, [0, 3, 6, 8, 11]] = True
    order = [int(v) for v in np.random.default_rng(6).permutation(13)]
    coords, geo = jax_geometry(tape, jaug._geometric_coords, cfg, keys, gates,
                               h, w, PACKED_NAMES)
    sy, sx, mode, cval, _, dy, dx = map(jnp.asarray, coords)
    j_img, j_seg = jaug._sample_nearest_packed(
        jnp.asarray(imgs), jnp.asarray(segs), sy, sx, mode, cval, dy, dx)
    j_img, photo = jax_pool(tape, cfg, keys, to_np(j_img), gates, order)
    want_img = to_np(jpipe.normalize_images(jnp.asarray(j_img),
                                            dtype=jnp.bfloat16))

    fn = taug.make_augment_fn(tcfg)
    params = {"gates": to_t(gates), "geometry": geo, "photo": photo,
              "order": order}
    post = PostFetch(
        augment_fn=lambda gen, i, s, host_gen=None: fn.apply(params, i, s),
        dtype=torch.bfloat16, device="cpu")
    got_img, got_seg, valid = post(Batch(imgs, segs, b))
    assert valid == b and got_img.shape == (b, h, w, 3)
    assert (got_seg.numpy() != to_np(j_seg)).mean() <= 0.001
    assert set(np.unique(got_seg.numpy())) <= {0, 3, 150}
    diff = np.abs(got_img.float().numpy() - want_img)
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    assert diff.max() <= 0.15 and diff.mean() <= 1e-3, (diff.max(),
                                                        diff.mean())


# ---------------------------------------------------------------------------
# the train CLI on the CPU
# ---------------------------------------------------------------------------

def _shallow(name, num_classes, **kwargs):
    return DeepLabV3Plus(num_classes=num_classes, backbone_layers=(1, 1, 1, 1),
                         **kwargs)


@pytest.mark.parametrize("flags", [["-s", "64", "48"],
                                   ["-s", "48", "48", "--fast-augment"]],
                         ids=["nonsquare", "fast_augment"])
def test_train_cli_epoch_on_the_cpu(flags, tmp_path, monkeypatch):
    """One epoch of `train` through the port's `main` (a shallow
    DeepLabV3+), then the epoch's eval; `--fast-augment` builds the
    fast_geometric policy."""
    monkeypatch.setattr(ttrain, "build_model", _shallow)
    built = []
    make = ttrain.make_augment_fn
    monkeypatch.setattr(ttrain, "make_augment_fn",
                        lambda cfg=None: built.append(cfg) or make(cfg))
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "coco")
    make_synthetic_coco(data, num_train=4, num_val=2, img_size=(80, 60),
                        seed=1, num_classes=3)
    trainer = ttrain.main([data, "--model", "deeplabv3plus", "--dataset",
                           "coco", "-bs", "2", "-a", "1", "--num-workers",
                           "1", "--epochs", "1", "--nosave"] + flags,
                          device="cpu")
    assert trainer.epoch == 1 and trainer.state.step == 2
    assert np.isfinite(trainer.metrics) and 0.0 <= trainer.metrics <= 1.0
    fast = "--fast-augment" in flags
    assert [c is not None and c.fast_geometric for c in built] == [fast]
    assert not osp.exists("weights/last.pt")
