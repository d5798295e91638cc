"""PyTorch port: the evaluation slice (the eval and predict steps, test-time
augmentation, sliding-window evaluation and serving, Boundary IoU, the
first-batch picture, `test()` and EMA loading) against the JAX package on the
same seeded weights and numpy inputs, on the CPU, in f32.

Sizes are cut for the test budget: DeepLabV3+ with ResNet layers (1,1,1,1),
3 classes, 64x64 for the two routes of the eval step; a two-convolution
model with stride-2 logits (and, like DeepLabV3+, an optional trailing
upsample behind `full_res_output`) for the options and for `test()`, so that
each JAX program compiles in about a second. Off the TPU the JAX step takes
its plain tail; the port's fused route runs the kernels' plain versions on
CPU tensors.

Tolerances: losses 1e-5 relative (f32 on both sides, sums in another order);
confusion counts are integers and equal, except that a pixel whose top-2 gap
in the f32 upsampled logits is below `torch_port_util.GAP` may flip and move
one count."""

import json
import re

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu import inference as jinference
from pytorch_segmentation_tpu.data import DataLoader as JaxDataLoader
from pytorch_segmentation_tpu.data import Fetcher as JaxFetcher
from pytorch_segmentation_tpu.data import PostFetch as JaxPostFetch
from pytorch_segmentation_tpu.engine import steps as jsteps
from pytorch_segmentation_tpu.engine import test as jax_test
from pytorch_segmentation_tpu.engine.trainer import ModelBundle
from pytorch_segmentation_tpu.models import DeepLabV3Plus as JaxDeepLabV3Plus
from pytorch_segmentation_tpu.ops import boundary as jboundary
from pytorch_segmentation_tpu.ops import tta as jtta
from pytorch_segmentation_tpu.ops.resize import resize_bilinear as jax_resize
from pytorch_segmentation_tpu_torch import inference as tinference
from pytorch_segmentation_tpu_torch.data import DataLoader, Fetcher, PostFetch
from pytorch_segmentation_tpu_torch.engine import Trainer
from pytorch_segmentation_tpu_torch.engine import steps as tsteps
from pytorch_segmentation_tpu_torch.engine import test as port_test
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.models import (build_model,
                                                   without_default_init)
from pytorch_segmentation_tpu_torch.ops import boundary as tboundary
from pytorch_segmentation_tpu_torch.ops import tta as ttta
from pytorch_segmentation_tpu_torch.ops.resize import resize_bilinear
from pytorch_segmentation_tpu_torch.parallel import make_mesh
from pytorch_segmentation_tpu_torch.utils.png import decode_png
from pytorch_segmentation_tpu_torch.utils.visualize import show_batch
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict, state_dict_from_jax)
from torch_port_util import GAP, assert_masks_agree

torch.set_num_threads(1)

NC, HW = 3, 64
LAYERS = (1, 1, 1, 1)
LOSS_RTOL = 1e-5


# ------------------------------------------------------------ the two models

class JaxTiny(fnn.Module):
    """conv 3x3 stride 2 -> ReLU -> conv 1x1: logits at half the input size,
    or at the input size behind `full_res_output`."""
    num_classes: int = NC
    full_res_output: bool = False

    @fnn.compact
    def __call__(self, x, train=False):
        y = fnn.Conv(8, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                     name="conv1")(x)
        y = fnn.Conv(self.num_classes, (1, 1), name="cls_conv")(fnn.relu(y))
        if self.full_res_output:
            y = jax_resize(y, (2 * y.shape[1], 2 * y.shape[2]),
                           align_corners=True)
        return y


class TorchTiny(torch.nn.Module):
    def __init__(self, num_classes=NC, full_res_output=False):
        super().__init__()
        self.full_res_output = full_res_output
        self.conv1 = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.cls_conv = torch.nn.Conv2d(8, num_classes, 1)

    def forward(self, x):
        y = self.cls_conv(torch.relu(self.conv1(x)))
        if self.full_res_output:
            y = resize_bilinear(y.permute(0, 2, 3, 1),
                                (2 * y.shape[2], 2 * y.shape[3]),
                                align_corners=True).permute(0, 3, 1, 2)
        return y


def _tiny_pair(full_res_output=False, num_classes=NC, seed=0):
    """(JAX ModelBundle, the port's eval-mode module) on the same weights."""
    rng = np.random.default_rng(seed)
    params = {
        "conv1": {"kernel": rng.standard_normal((3, 3, 3, 8)) * 0.3,
                  "bias": rng.standard_normal(8) * 0.1},
        "cls_conv": {"kernel": rng.standard_normal((1, 1, 8, num_classes)),
                     "bias": rng.standard_normal(num_classes) * 0.1}}
    params = {k: {n: a.astype(np.float32) for n, a in v.items()}
              for k, v in params.items()}
    model = TorchTiny(num_classes, full_res_output)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(params, {}).items()})
    return (ModelBundle(JaxTiny(num_classes, full_res_output), params, {}),
            model.eval())


def _jax_state(bundle, full_res_output=False):
    return jsteps.TrainState(
        step=0, params=bundle.params, batch_stats=bundle.batch_stats,
        opt_state=None, tx=None,
        apply_fn=bundle.module.clone(full_res_output=full_res_output).apply)


def _batch(b=3, hw=(HW, HW), nc=NC, seed=1):
    rng = np.random.default_rng(seed)
    # labels in blocks, so that Boundary IoU has bands to intersect
    blocks = rng.integers(0, nc, (b, -(-hw[0] // 8), -(-hw[1] // 8)))
    segs = np.kron(blocks, np.ones((8, 8), np.int64))[:, :hw[0], :hw[1]]
    return (rng.standard_normal((b, *hw, 3)).astype(np.float32),
            segs.astype(np.int32))


def _unclear(model, images, out_hw, align=True):
    """How many pixels of the port's f32 upsampled logits have a top-2 gap
    of at most GAP: each may flip under another summation order."""
    with torch.inference_mode():
        logits = tsteps.nhwc_forward(model)(torch.from_numpy(images))
        up = resize_bilinear(logits.float(), out_hw, align_corners=align)
    top2 = up.topk(2, dim=-1).values
    return int(((top2[..., 0] - top2[..., 1]) <= GAP).sum())


def _assert_step_results(got, want, slack=0):
    assert len(got) == len(want)
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    assert got[0].shape == () and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() <= slack, (g, w, slack)


# ------------------------------------------------- the eval step, DeepLabV3+

@pytest.fixture(scope="module")
def deeplab():
    """The port's small f32 DeepLabV3+ (stride-4 twin semantics live in
    `test()`; here the modules are built with full_res_output=False), the
    JAX step's results on one batch with valid=3 of 4, and the batch."""
    with without_default_init():   # every entry seeded next
        model = build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                            dtype=torch.float32, full_res_output=False)
    sd = seeded_state_dict(model, seed=0)
    model.load_state_dict(sd)
    params, stats = jax_trees_from_state_dict(sd)
    module = JaxDeepLabV3Plus(num_classes=NC, backbone_layers=LAYERS,
                              dtype=jnp.float32, full_res_output=False)
    state = jsteps.TrainState(step=0, params=params, batch_stats=stats,
                              opt_state=None, tx=None, apply_fn=module.apply)
    images, segs = _batch(b=4, seed=2)
    want = jsteps.make_eval_step(NC)(state, jnp.asarray(images),
                                     jnp.asarray(segs), jnp.asarray(3))
    return model.eval(), images, segs, want


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["fused", "plain_tail"])
def test_eval_step_matches_jax_on_deeplab(deeplab, use_kernels):
    model, images, segs, want = deeplab
    step = tsteps.make_eval_step(NC, use_kernels=use_kernels)
    got = step(model, torch.from_numpy(images), torch.from_numpy(segs), 3)
    assert all(not g.requires_grad for g in got)
    _assert_step_results(got, want, slack=_unclear(model, images, (HW, HW)))
    counted = float(got[1].sum() + got[2].sum())
    assert counted == 3 * HW * HW        # the padded sample is left out
    # a mask of the same samples is the same step
    same = step(model, torch.from_numpy(images), torch.from_numpy(segs),
                torch.tensor([True, True, True, False]))
    for a, b in zip(got, same):
        assert torch.equal(a, b)


def test_eval_step_refuses_a_train_mode_module(deeplab):
    model, images, segs, _ = deeplab
    try:
        with pytest.raises(ValueError, match="eval-mode"):
            tsteps.make_eval_step(NC)(model.train(), torch.from_numpy(images),
                                      torch.from_numpy(segs), 4)
        with pytest.raises(ValueError, match="eval-mode"):
            tsteps.make_predict_step()(model, torch.from_numpy(images),
                                       (HW, HW))
    finally:
        model.eval()


# ----------------------------------------- the eval step's options, tiny model

OPTIONS = {
    "flip": dict(tta_flip=True),
    "scales": dict(tta_scales=(0.5, 1.5)),
    "flip_and_scales": dict(tta_flip=True, tta_scales=(1.0, 1.5)),
    "ignore_index": dict(ignore_index=255),
    "tile": dict(tile=(32, 32), tile_overlap=0.25),
    "tile_larger_than_the_image": dict(tile=(96, 80)),
    "tile_flip_ignore": dict(tile=(48, 32), tta_flip=True, ignore_index=255),
    "boundary": dict(boundary_ratio=0.05),
    "boundary_ignore": dict(boundary_ratio=0.02, ignore_index=255),
    "align_corners_false": dict(align_corners=False),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_eval_step_options_match_jax(name):
    options = OPTIONS[name]
    bundle, model = _tiny_pair()
    images, segs = _batch()
    if options.get("ignore_index") is not None:
        segs[0, :9] = 255
        segs[1, 20:30, 5] = 255
        segs[2] = 255                  # a padded sample, all ignored
    want = jsteps.make_eval_step(NC, **options)(
        _jax_state(bundle), jnp.asarray(images), jnp.asarray(segs),
        jnp.asarray(2))
    got = tsteps.make_eval_step(NC, **options)(
        model, torch.from_numpy(images), torch.from_numpy(segs), 2)
    assert len(got) == (6 if "boundary_ratio" in options else 4)
    _assert_step_results(got, want)
    if not ({"ignore_index", "tile", "boundary_ratio"} & set(options)):
        plain = tsteps.make_eval_step(NC, use_kernels=False, **options)(
            model, torch.from_numpy(images), torch.from_numpy(segs), 2)
        _assert_step_results(plain, want)


def test_labels_outside_the_classes_differ_between_the_routes():
    """No ignore_index, a label of 255: the plain tail (the JAX step off the
    TPU) drops the pixel from the counts and its loss is NaN; the fused
    route counts a false positive and a true logit of 0, as the TPU kernels
    do."""
    bundle, model = _tiny_pair()
    images, segs = _batch()
    segs[0, :4] = 255
    want = jsteps.make_eval_step(NC)(_jax_state(bundle), jnp.asarray(images),
                                     jnp.asarray(segs), jnp.asarray(3))
    args = (model, torch.from_numpy(images), torch.from_numpy(segs), 3)
    plain = tsteps.make_eval_step(NC, use_kernels=False)(*args)
    assert np.isnan(float(want[0])) and np.isnan(float(plain[0]))
    for g, w in zip(plain[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fused = tsteps.make_eval_step(NC)(*args)
    assert np.isfinite(float(fused[0]))
    outside = 4 * HW
    assert float(plain[1].sum() + plain[3].sum()) == 3 * HW * HW - outside
    assert float(fused[1].sum() + fused[3].sum()) == 3 * HW * HW
    assert float(fused[1].sum() + fused[2].sum()) == 3 * HW * HW - outside


def test_quantized_eval_without_eligible_convs_is_the_plain_eval():
    """The tiny pair has no ConvNormAct: make_eval_step(quant=True), with
    or without the calibrated fifth argument, gives the plain step's
    results bit for bit."""
    _, model = _tiny_pair()
    x, y = (torch.from_numpy(a) for a in _batch())
    want = tsteps.make_eval_step(NC)(model, x, y, 3)
    for stats in (None, {}):
        got = tsteps.make_eval_step(NC, quant=True)(model, x, y, 3, stats)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_predict_step_matches_jax():
    bundle, model = _tiny_pair()
    images, _ = _batch()
    x = torch.from_numpy(images)
    for out_hw in ((HW, HW), (32, 32), (80, 72)):
        want = np.asarray(jsteps.make_predict_step()(
            _jax_state(bundle), jnp.asarray(images), out_hw))
        with torch.inference_mode():
            up = resize_bilinear(tsteps.nhwc_forward(model)(x), out_hw,
                                 align_corners=True)
        for use_kernels in (True, False):
            got = tsteps.make_predict_step(use_kernels=use_kernels)(
                model, x, out_hw)
            assert got.dtype == torch.int32
            assert_masks_agree(got.numpy(), want, up.numpy())


# ------------------------------------------------------------------- ops/tta

def test_tta_scale_helpers_match_jax():
    for scales in (None, (), (1.0,), (0.5, 1.5), [0.75, 1, 1.25, 0.75],
                   (0, -1, 2), ("0.5", 1.0000001)):
        assert ttta.normalize_tta_scales(scales) == jtta.normalize_tta_scales(
            scales)
    for hw in ((513, 513), (64, 64), (33, 100), (769, 1025)):
        for scale in (0.25, 0.5, 0.75, 1.25, 1.5, 2.0):
            assert ttta.snap_scale_size(hw, scale) == jtta.snap_scale_size(
                hw, scale)
    assert ttta.snap_scale_size((513, 513), 0.75) == (384, 384)
    assert ttta.snap_scale_size((513, 513), 1.25) == (640, 640)


@pytest.mark.parametrize("scales,flip", [((), True), ((0.5, 1.5), False),
                                         ((1.5, 1.0, 0.5), True), ((), False)])
def test_tta_logits_match_jax(scales, flip):
    """f32 on both sides: 1e-5 of the largest logit."""
    bundle, model = _tiny_pair()
    images, _ = _batch(hw=(64, 96))
    want = np.asarray(jtta.tta_logits(
        lambda x: bundle.apply_fn({"params": bundle.params}, x), jnp.asarray(
            images), scales=scales, flip=flip))
    with torch.inference_mode():
        got = ttta.tta_logits(tsteps.nhwc_forward(model),
                              torch.from_numpy(images), scales=scales,
                              flip=flip)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_tta_logits_keep_the_base_dtype_and_flip_width():
    """bf16 logits come back bf16; the flip is along W, not H."""
    calls = []

    def fwd(x):
        calls.append(x)
        return x[..., :2].to(torch.bfloat16)

    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    out = ttta.tta_logits(fwd, x, flip=True)
    assert out.dtype == torch.bfloat16 and len(calls) == 2
    assert torch.equal(calls[1], x.flip(2))
    assert torch.equal(out, x[..., :2].to(torch.bfloat16))


# ------------------------------------------------------- sliding-window paths

def test_tile_offsets_equal():
    for size in (1, 16, 17, 31, 32, 33, 64, 100, 513, 769, 1025):
        for tile in (16, 32, 513):
            for overlap in (0.0, 0.25, 1 / 3, 0.5, 0.9):
                assert tinference._tile_offsets(size, tile, overlap) == (
                    jinference._tile_offsets(size, tile, overlap))


@pytest.mark.parametrize("hw,tile,overlap,edge_pad", [
    ((40, 56), (32, 32), 0.25, 0.0),
    ((64, 64), (32, 48), 1 / 3, 0.0),
    ((20, 40), (32, 32), 0.5, 1.5),     # shorter than a tile: padded
])
def test_tiled_logits_match_jax(hw, tile, overlap, edge_pad):
    bundle, model = _tiny_pair(full_res_output=True)
    images, _ = _batch(b=2, hw=hw)
    want = np.asarray(jsteps.tiled_logits(
        lambda x: bundle.apply_fn({"params": bundle.params}, x),
        jnp.asarray(images), tile, overlap, edge_pad=edge_pad))
    with torch.inference_mode():
        got = tsteps.tiled_logits(tsteps.nhwc_forward(model),
                                  torch.from_numpy(images), tile, overlap,
                                  edge_pad=edge_pad)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _u8_images(b, hw, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (b, *hw, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("hw,kw", [
    ((40, 56), dict(tile_hw=(32, 32))),
    ((64, 64), dict(tile_hw=(32, 32), overlap=0.5, tta_flip=True)),
    ((24, 40), dict(tile_hw=(32, 32))),             # padded with the mean
    ((64, 64), dict(tile_hw=(64, 64), tta_scales=(0.5,))),
])
def test_make_tiled_mask_fn_matches_jax(hw, kw):
    bundle, model = _tiny_pair()
    images = _u8_images(2, hw)
    want = np.asarray(jinference.make_tiled_mask_fn(bundle, **kw)(images))
    got = tinference.make_tiled_mask_fn(model, **kw)(images)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, *hw)
    # f32 canvas sums in another order: a near-tie pixel may flip
    assert (got.numpy() == want).mean() >= 0.999
    if "tta_flip" not in kw and "tta_scales" not in kw:
        # one tile that covers the image is the plain serving function
        one = tinference.make_tiled_mask_fn(model, tile_hw=hw)(images)
        assert torch.equal(one, tinference.make_mask_fn(model)(images))


@pytest.mark.parametrize("kw", [
    dict(tta_flip=True), dict(tta_scales=(0.5, 1.5)),
    dict(tta_flip=True, tta_scales=(1.5,), out_hw=(80, 72)),
    dict(legacy_preproc=True, tta_flip=True)])
def test_make_mask_fn_with_tta_matches_jax(kw):
    bundle, model = _tiny_pair()
    images = _u8_images(2, (HW, HW))
    want = np.asarray(jinference.make_mask_fn(bundle, **kw)(images))
    got = tinference.make_mask_fn(model, **kw)(images)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert (got.numpy() == want).mean() >= 0.999
    plain = tinference.make_mask_fn(model, out_hw=kw.get("out_hw"),
                                    legacy_preproc=kw.get("legacy_preproc",
                                                          False))(images)
    assert not torch.equal(got, plain)   # the augmentation did take part


# --------------------------------------------------------------- ops/boundary

def test_boundary_pixels_equal():
    for hw in ((513, 513), (64, 64), (1024, 2048), (10, 10)):
        for ratio in (0.02, 0.05, 0.001):
            assert tboundary.boundary_pixels(*hw, ratio) == (
                jboundary.boundary_pixels(*hw, ratio))


@pytest.mark.parametrize("d", [1, 3, 15])
def test_mask_to_band_equals_jax(d):
    rng = np.random.default_rng(d)
    blocks = rng.random((3, 7, 9)) < 0.5
    mask = np.kron(blocks, np.ones((6, 5), bool))       # [3, 42, 45]
    mask[0, :, :2] = True                               # touches the edge
    want = np.asarray(jboundary.mask_to_band(jnp.asarray(mask), d))
    got = tboundary.mask_to_band(torch.from_numpy(mask), d)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    one = tboundary.mask_to_band(torch.from_numpy(mask[1]), d)   # [H, W]
    np.testing.assert_array_equal(one.numpy(), want[1])


@pytest.mark.parametrize("with_valid", [False, True])
def test_boundary_confusion_and_iou_match_jax(with_valid):
    rng = np.random.default_rng(5)
    _, target = _batch(b=2, hw=(48, 40), nc=4, seed=6)
    pred = np.roll(target, 2, axis=2)
    valid = None
    if with_valid:
        valid = rng.random(target.shape) < 0.9
    want = jboundary.boundary_confusion(
        jnp.asarray(pred), jnp.asarray(target), 4, 2,
        valid=None if valid is None else jnp.asarray(valid))
    got = tboundary.boundary_confusion(
        torch.from_numpy(pred), torch.from_numpy(target), 4, 2,
        valid=None if valid is None else torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0].sum()) > 0
    iou = tboundary.boundary_iou(*got)
    np.testing.assert_allclose(iou.numpy(),
                               np.asarray(jboundary.boundary_iou(*want)),
                               rtol=1e-6)
    zero = tboundary.boundary_iou(np.zeros(3), np.zeros(3))  # the guard
    assert torch.equal(zero, torch.zeros(3))


# -------------------------------------------------------------------- test()

class MemoryDataset:
    """u8 images and block labels in host memory, with class names."""

    def __init__(self, n, hw, names, seed=7):
        rng = np.random.default_rng(seed)
        self.classes = list(names)
        self.images = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
        self.segs = _batch(b=n, hw=hw, nc=len(names), seed=seed)[1].astype(
            np.uint8)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.segs[i]


TABLE_LINE = re.compile(
    r"^cls: +(\S+), targets: +(\d+), pre: +(\S+), rec: +(\S+), iou: +(\S+), "
    r"F1: +(\S+)$")


def _table(text):
    """The printed per-class table: [(name, targets, pre, rec, iou, F1)] and
    the other lines that are neither table nor progress."""
    rows, other = [], []
    for line in text.splitlines():
        m = TABLE_LINE.match(line)
        if m:
            rows.append((m.group(1), int(m.group(2)),
                         *(float(m.group(i)) for i in range(3, 7))))
        elif line and "loss:" not in line:
            other.append(line)
    return rows, other


@pytest.mark.parametrize("names,kw", [
    (("background", "a", "b"), {}),
    (tuple(f"c{i}" for i in range(12)), {}),              # "top error 5"
    (("background", "a", "b"), dict(boundary_ratio=0.05, tta_flip=True)),
], ids=["3_classes", "12_classes", "boundary_flip"])
def test_test_matches_jax_end_to_end(tmp_path, capsys, monkeypatch, names,
                                     kw):
    """12 images at batch 8: the last batch is padded by 4. A
    full_res_output model on both sides, so both evaluate its low-res twin.
    mIoU within 1e-6, the report key for key, the printed table line for
    line."""
    monkeypatch.chdir(tmp_path)                       # batch.png lands here
    nc = len(names)
    bundle, model = _tiny_pair(full_res_output=True, num_classes=nc)
    dataset = MemoryDataset(12, (32, 32), names)
    want_miou = jax_test(
        bundle, JaxFetcher(JaxDataLoader(dataset, 8, num_workers=1),
                           JaxPostFetch()),
        show_first_batch=False, report_path=str(tmp_path / "jax.json"), **kw)
    want_rows, want_other = _table(capsys.readouterr().out)
    got_miou = port_test(
        model, Fetcher(DataLoader(dataset, 8, num_workers=1),
                       PostFetch(device="cpu")),
        report_path=str(tmp_path / "port.json"), device="cpu", **kw)
    got_rows, got_other = _table(capsys.readouterr().out)

    assert model.full_res_output is True              # the twin was a copy
    assert abs(got_miou - want_miou) <= 1e-6
    assert got_other == want_other
    assert len(got_rows) == len(want_rows) == (nc if nc < 10 else 5)
    for g, w in zip(got_rows, want_rows):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(g[2:], w[2:], rtol=1e-5)

    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert list(got) == list(want)
    assert got["num_classes"] == want["num_classes"] == nc
    for key in ("miou", "val_loss", "mean_boundary_iou", "boundary_ratio"):
        assert (key in got) == (key in want)
        if key in got:
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       atol=1e-6)
    total = 0
    for g, w in zip(got["per_class"], want["per_class"]):
        assert list(g) == list(w) and g["name"] == w["name"]
        for key in ("targets", "tp", "fn", "fp"):
            assert g[key] == w[key], key
        for key in set(g) - {"name", "targets", "tp", "fn", "fp"}:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=1e-7)
        total += g["tp"] + g["fn"]
    assert total == 12 * 32 * 32                      # padding left out

    # the first batch's picture: 8 rows of image | mask
    picture = decode_png((tmp_path / "batch.png").read_bytes())
    assert picture.shape == (8 * 32, 64, 3)


def test_test_quiet_and_unported_options(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, model = _tiny_pair(full_res_output=True)
    fetcher = Fetcher(DataLoader(MemoryDataset(5, (32, 32), "abc"), 4,
                                 num_workers=1), PostFetch(device="cpu"))
    miou = port_test(model, fetcher, show_first_batch=False, log=False,
                     device="cpu")
    assert 0.0 <= miou <= 1.0
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "batch.png").exists()
    # int8 is ported: a model without an eligible conv evaluates as before
    for kw in (dict(int8=True), dict(quant_stats={})):
        assert port_test(model, fetcher, show_first_batch=False, log=False,
                         device="cpu", **kw) == miou
    # a one-device mesh of one process: the same evaluation
    mesh = make_mesh(devices=["cpu"])
    assert port_test(model, fetcher, show_first_batch=False, log=False,
                     device="cpu", mesh=mesh) == miou
    with pytest.raises(ValueError, match="one process per card"):
        port_test(model, fetcher, mesh=make_mesh(devices=["cpu", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_test(model, fetcher)                 # no silent CPU
    with pytest.raises(ValueError, match="the model is on"):
        port_test(model, fetcher, device="meta")


def test_results_are_read_one_batch_late(monkeypatch):
    """The host reads batch k's results only after batch k+1 is enqueued."""
    from pytorch_segmentation_tpu_torch.engine import evaluate
    _, model = _tiny_pair()
    fetcher = Fetcher(DataLoader(MemoryDataset(12, (32, 32), "abc"), 4,
                                 num_workers=1), PostFetch(device="cpu"))
    events = []

    class Recording(evaluate._Pending):
        def __init__(self, results):
            events.append("enqueue")
            super().__init__(results)

        def read(self):
            events.append("read")
            return super().read()

    monkeypatch.setattr(evaluate, "_Pending", Recording)
    port_test(model, fetcher, show_first_batch=False, log=False, device="cpu")
    assert events == ["enqueue", "enqueue", "read", "enqueue", "read", "read"]


# ----------------------------------------------- picture, EMA, train -> eval

def test_show_batch_writes_a_png(tmp_path):
    images, _ = _batch(b=10, hw=(16, 24))
    preds = np.random.default_rng(8).integers(0, 21, (10, 8, 12))
    path = str(tmp_path / "b.png")
    canvas = show_batch(torch.from_numpy(images).to(torch.bfloat16), preds,
                        path=path)
    assert canvas.shape == (8 * 16, 48, 3) and canvas.dtype == np.uint8
    np.testing.assert_array_equal(decode_png(open(path, "rb").read()), canvas)
    # against the JAX package's picture (BGR for OpenCV) on the same values:
    # the same image with the channels reversed
    from pytorch_segmentation_tpu.utils.visualize import (
        show_batch as jax_show_batch)
    want = jax_show_batch(
        torch.from_numpy(images).to(torch.bfloat16).float().numpy(), preds,
        path=str(tmp_path / "j.png"))
    np.testing.assert_array_equal(canvas, want[..., ::-1])


def test_load_model_bundle_use_ema(tmp_path):
    def build():   # every entry seeded or loaded next
        with without_default_init():
            return build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                               dtype=torch.float32)

    sd = seeded_state_dict(build(), seed=1)
    ema = {k: v + 0.25 for k, v in sd.items()
           if not ("running_" in k or "num_batches" in k)}
    path = str(tmp_path / "ema.pt")
    save_checkpoint(path, sd, ema=ema)
    raw = load_model_bundle(build(), path, "cpu")
    avg = load_model_bundle(build(), path, "cpu", use_ema=True)
    assert not avg.training
    for k, v in avg.state_dict().items():
        want = ema.get(k, sd[k])       # BN statistics stay the checkpoint's
        assert torch.equal(v, want), k
        assert torch.equal(raw.state_dict()[k], sd[k]), k
    save_checkpoint(path, sd)
    with pytest.raises(ValueError, match="no EMA"):
        load_model_bundle(build(), path, "cpu", use_ema=True)
    with pytest.raises(ValueError, match="needs a checkpoint"):
        load_model_bundle(build(), None, "cpu", use_ema=True)


def test_train_eval_save_best_round_trip(tmp_path, monkeypatch):
    """What a training script does after every epoch: step, evaluate the
    live model and the EMA model, keep the best, and find the same mIoU in
    the reloaded best.pt."""
    monkeypatch.chdir(tmp_path)
    dataset = MemoryDataset(6, (HW, HW), ("background", "a", "b"))
    val = Fetcher(DataLoader(dataset, 4, num_workers=1),
                  PostFetch(device="cpu"))
    train = Fetcher(DataLoader(dataset, 2, shuffle=True, drop_last=True,
                               num_workers=1), PostFetch(device="cpu"))
    with without_default_init():   # the Trainer seeds every entry
        model = build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                            dtype=torch.float32, full_res_output=True)
    trainer = Trainer(model, train, workdir=str(tmp_path / "w"), lr=1e-3,
                      ema_decay=0.5, log=False,
                      log_dir=str(tmp_path / "runs"), device="cpu")
    trainer.step()
    miou = port_test(trainer.model, val, show_first_batch=False, log=False,
                     device="cpu")
    ema_miou = port_test(trainer.ema_model, val, show_first_batch=False,
                         log=False, device="cpu")
    assert 0.0 <= miou <= 1.0 and 0.0 <= ema_miou <= 1.0
    trainer.metrics = miou
    trainer.save(best=True)
    trainer.step()                     # training goes on after an eval

    def build():   # loaded strictly next
        with without_default_init():
            return build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                               dtype=torch.float32, full_res_output=True)

    best = str(tmp_path / "w" / "best.pt")
    assert torch.load(best, weights_only=True)["best_miou"] == miou
    for use_ema, want in ((False, miou), (True, ema_miou)):
        loaded = load_model_bundle(build(), best, "cpu", use_ema=use_ema)
        assert port_test(loaded, val, show_first_batch=False, log=False,
                         device="cpu") == want
