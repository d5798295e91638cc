"""PyTorch port: UNet on MobileNetV2 against the JAX package on the same
seeded weights and inputs, on the CPU: the weights' mapping, the f32 and
bf16 forwards, `make_mask_fn`, one `Trainer` step, `engine.test`, and the
folded `InvertedResidual` (the fused 1x1 switch on) against the JAX block
under 'interpret'. 5 classes, 64x64 inputs (the least multiple of 32 with
a 2x2 stride-32 map), batch 2. Each JAX program is compiled once."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.data import DataLoader as JaxDataLoader
from pytorch_segmentation_tpu.data import Fetcher as JaxFetcher
from pytorch_segmentation_tpu.data import PostFetch as JaxPostFetch
from pytorch_segmentation_tpu.engine import test as jax_test
from pytorch_segmentation_tpu.engine.trainer import ModelBundle
from pytorch_segmentation_tpu.models import UNet as JaxUNet
from pytorch_segmentation_tpu.nn import blocks as jblocks
from pytorch_segmentation_tpu.nn.backbones.mobilenetv2 import (
    InvertedResidual as JaxInvertedResidual)
from pytorch_segmentation_tpu.ops.resize import upsample2x as jax_upsample2x
from pytorch_segmentation_tpu_torch.data import DataLoader, Fetcher, PostFetch
from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.engine import steps as tsteps
from pytorch_segmentation_tpu_torch.engine import test as port_test
from pytorch_segmentation_tpu_torch.nn import blocks as tblocks
from pytorch_segmentation_tpu_torch.nn.backbones.mobilenetv2 import (
    InvertedResidual)
from pytorch_segmentation_tpu_torch.ops.kernels import fused_matmul_bn as fm
from pytorch_segmentation_tpu_torch.ops.resize import (resize_bilinear,
                                                       upsample2x)
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict, state_dict_from_jax)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, assert_weights_match_jax,
                               jax_train_step, numpy_tree, port_trainer_step,
                               train_batch)
from torch_port_util import GAP

torch.set_num_threads(1)

NC, HW = 5, 64


@pytest.fixture(autouse=True)
def _switches_off():
    """Both packages' fused 1x1 switches are process-wide: leave them off."""
    yield
    tblocks.set_force_fused_1x1(None)
    jblocks.set_force_fused_1x1(None)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return FamilyCase("unet", JaxUNet, NC, HW, tmp_path_factory.mktemp("unet"))


@pytest.fixture(scope="module")
def f32(case):
    """The JAX UNet's stride-2 f32 logits [2, 32, 32, NC] (twice: no probe,
    the bf16 bounds are held at the logits, where the two packages' bf16
    forwards are equal bit for bit)."""
    return case.jax_logits()


def test_upsample2x_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    for align in (True, False):
        got = upsample2x(torch.from_numpy(x), align_corners=align)
        assert got.shape == (2, 10, 14, 3)
        # the same two f32 contractions; XLA may fuse a multiply-add
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jax_upsample2x(jnp.asarray(x), align)),
            rtol=1e-6, atol=1e-6)


def test_state_dict_equals_jax_export(case):
    assert_weights_match_jax(case)
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (2, True)
    # the depthwise kernels: (C, 1, 3, 3), one group a channel
    dw = model.backbone.stage1_block0.depthwise.conv
    assert dw.groups == 96 and tuple(dw.weight.shape) == (96, 1, 3, 3)
    assert model.backbone.stage0_block0.expand is None


@pytest.mark.parametrize("full_res_output,dtype", [
    pytest.param(False, torch.float32, id="False"),
    pytest.param(True, torch.float32, id="True"),
    pytest.param(False, torch.bfloat16, id="bf16")])
def test_forward_matches_jax(case, f32, full_res_output, dtype):
    bf16 = (case.jax_logits(jnp.bfloat16) if dtype == torch.bfloat16
                else None)
    assert_forward_matches_jax(case, full_res_output, dtype, f32,
                               bf16)


@pytest.mark.parametrize("out_hw", [None, (80, 72)])
def test_make_mask_fn_matches_jax(case, f32, out_hw):
    assert_mask_fn_matches_jax(case, f32, out_hw)


def test_trainer_step_matches_jax(case, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution UNet, through its stride-2 twin and the upsample+CE
    loss with align_corners=True, against the JAX train step on the same
    start and batch."""
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")


class MemoryDataset:
    """u8 images and 8x8-block labels in host memory, with class names."""

    def __init__(self, n, hw, num_classes, seed=7):
        rng = np.random.default_rng(seed)
        self.classes = [f"c{i}" for i in range(num_classes)]
        self.images = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
        blocks = rng.integers(0, num_classes, (n, hw // 8, hw // 8))
        self.segs = np.kron(blocks, np.ones((8, 8), np.int64)).astype(
            np.uint8)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.segs[i]


def test_engine_test_matches_jax(case, tmp_path, monkeypatch):
    """`engine.test` of the full-resolution UNet (its stride-2 twin, the
    eval step's upsample with align_corners=True) against the JAX `test()`
    on 10 images at batch 8, the last batch padded: the counts equal but for
    pixels whose top-2 gap is at most GAP, the loss to 1e-5 and the mIoU to
    what those pixels can move."""
    monkeypatch.chdir(tmp_path)
    dataset = MemoryDataset(10, HW, NC)
    bundle = ModelBundle(case.jax_module(full_res_output=True), case.params,
                         case.stats)
    want_miou = jax_test(
        bundle, JaxFetcher(JaxDataLoader(dataset, 8, num_workers=1),
                           JaxPostFetch()),
        show_first_batch=False, log=False,
        report_path=str(tmp_path / "jax.json"))
    model = case.loaded(full_res_output=True)
    got_miou = port_test(
        model, Fetcher(DataLoader(dataset, 8, num_workers=1),
                       PostFetch(device="cpu")),
        show_first_batch=False, log=False,
        report_path=str(tmp_path / "port.json"), device="cpu")
    assert model.full_res_output is True              # the twin was a copy
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    # pixels of the f32 logits whose top-2 gap may flip between packages
    twin = copy.copy(model)
    twin.full_res_output = False
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(dataset.images))
        up = resize_bilinear(tsteps.nhwc_forward(twin)(x).float(), (HW, HW),
                             align_corners=True)
    top2 = up.topk(2, dim=-1).values
    slack = int(((top2[..., 0] - top2[..., 1]) <= GAP).sum())
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    total = 0
    for g, w in zip(got["per_class"], want["per_class"]):
        assert g["targets"] == w["targets"]
        for key in ("tp", "fn", "fp"):
            assert abs(g[key] - w[key]) <= slack, (key, g, w, slack)
        total += g["tp"] + g["fn"]
    assert total == 10 * HW * HW                       # padding left out
    assert abs(got_miou - want_miou) <= 1e-6 + 2 * slack / (HW * HW)
    assert 0.0 < got_miou < 1.0


# ------------------------------------------------ the folded InvertedResidual

def _block_pair(stride, cin, features):
    """The JAX InvertedResidual (expand 6, f32) and the port's on the same
    seeded weights, and an input both see (NHWC numpy)."""
    tm = InvertedResidual(cin, features, stride, 6, dtype=torch.float32)
    sd = seeded_state_dict(tm, seed=0, init="uniform")
    tm.load_state_dict(sd)
    params, stats = jax_trees_from_state_dict(sd)
    jm = JaxInvertedResidual(features, stride, 6, dtype=jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 8, 8, cin)).astype(
        np.float32)
    return jm, params, stats, tm, x


def _port_block_train(tm, x):
    """Output, parameter gradients of sum(y^2) and the buffers after one
    train-mode call of a copy of `tm` (NHWC numpy in and out)."""
    tm = copy.deepcopy(tm).train()
    y = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad((y ** 2).sum(), list(tm.parameters()))
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            dict(zip(names, (g.numpy() for g in grads))),
            {k: v.numpy() for k, v in tm.state_dict().items()})


def test_fused_inverted_residual_matches_jax():
    """The port's block with the switch on (expand with the 'none'
    prologue, project with 'relu6', both through `fused_bn_act_matmul`)
    against the JAX block under 'interpret' (its Pallas kernels in
    interpret mode), f32, on the residual shape: eval output, train output,
    running statistics and parameter gradients, at the tolerances of
    tests/test_torch_fused_1x1.py's Bottleneck test."""
    jm, params, stats, tm, x = _block_pair(1, 16, 16)
    jblocks.set_force_fused_1x1("interpret")
    tblocks.set_force_fused_1x1("on")
    calls = []
    real = tblocks.fused_bn_act_matmul

    def counting(*args, **kwargs):
        calls.append(kwargs["act"])
        return real(*args, **kwargs)

    tblocks.fused_bn_act_matmul = counting
    try:
        with torch.no_grad():
            ty = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert calls == ["none", "relu6"]
        jy = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
        np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jy), rtol=1e-4, atol=1e-4)

        def loss_fn(p):
            y, mut = jm.apply({"params": p, "batch_stats": stats},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
            return jnp.sum(y ** 2), (y, mut["batch_stats"])

        (_, (jy, jstats)), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        ty, tgrads, tstate = _port_block_train(tm, x)
    finally:
        tblocks.fused_bn_act_matmul = real
    np.testing.assert_allclose(ty, np.asarray(jy), rtol=1e-4, atol=1e-4)
    want = state_dict_from_jax(numpy_tree(jgrads), {})
    assert sorted(want) == sorted(tgrads)
    for name, g in want.items():
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-3, atol=1e-3,
                                   err_msg=name)
    for name, v in state_dict_from_jax({}, numpy_tree(jstats)).items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(tstate[name], v, rtol=1e-3, atol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("stride,cin,features", [(1, 16, 16), (2, 16, 24)],
                         ids=["residual", "strided"])
def test_fused_inverted_residual_matches_plain_path(stride, cin, features):
    """Switch on against off inside the port, same module and state_dict:
    outputs, gradients, buffers (f32: the two paths differ only in
    summation order). The unit fold of expand's prologue is no part of the
    state_dict."""
    _, _, _, tm, x = _block_pair(stride, cin, features)
    tblocks.set_force_fused_1x1("off")
    off = _port_block_train(tm, x)
    with torch.no_grad():
        eval_off = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    tblocks.set_force_fused_1x1("on")
    on = _port_block_train(tm, x)
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
    assert int(on[2]["expand.bn.num_batches_tracked"]) == 1
    assert not any("unit" in name for name in tm.state_dict())


def test_unet_switch_routes_every_expand_and_project(case):
    """With the switch on, one UNet forward calls the fused function for
    each of MobileNetV2's 16 expand ('none' prologue) and 16 project
    ('relu6') convolutions and nowhere else; the expand_ratio-1 block and
    the decoder keep the plain path. On the CPU no kernel launches."""
    model = case.loaded()
    calls = []
    real = tblocks.fused_bn_act_matmul

    def counting(*args, **kwargs):
        calls.append((args[0].shape[-1], args[3].shape[-1], kwargs["act"]))
        return real(*args, **kwargs)

    x = torch.from_numpy(case.images).permute(0, 3, 1, 2).float() / 255.0
    tblocks.set_force_fused_1x1("on")
    tblocks.fused_bn_act_matmul = counting
    fm.reset_launch_count()
    try:
        with torch.no_grad():
            on = model(x)
    finally:
        tblocks.fused_bn_act_matmul = real
    tblocks.set_force_fused_1x1("off")
    with torch.no_grad():
        off = model(x)
    assert [act for _, _, act in calls] == ["none", "relu6"] * 16
    assert calls[:2] == [(16, 96, "none"), (96, 24, "relu6")]
    assert calls[-1] == (960, 320, "relu6")
    assert fm.launch_count() == {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-4, atol=1e-4)
