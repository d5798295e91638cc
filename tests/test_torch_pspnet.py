"""PyTorch port: PSPNet (with and without its auxiliary head) and FastFCN
against the JAX package on the same seeded weights and inputs, on the CPU:
`adaptive_avg_pool2d`, `SeparableConvNormAct`, the weights' mapping, the
f32 and bf16 forwards, `make_mask_fn` (stride-8 logits,
align_corners=True), one aux `Trainer` step against the JAX train step,
the train-only entries that `load_model_bundle` drops, a warm start from a
checkpoint without the head, and `--aux-loss` on the command lines. 5
classes, 64x64 inputs, batch 2, one block a stage (`backbone_layers=(1, 1,
1, 1)`) at the published widths (the 4096 -> 512 head included). Each JAX
program is compiled once."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import PSPNet as JaxPSPNet
from pytorch_segmentation_tpu.nn.blocks import (
    SeparableConvNormAct as JaxSeparableConvNormAct)
from pytorch_segmentation_tpu.ops.pool import (
    adaptive_avg_pool2d as jax_adaptive_avg_pool2d)
from pytorch_segmentation_tpu_torch import test as ttest
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.engine.steps import nhwc_forward
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.models import build_model
from pytorch_segmentation_tpu_torch.nn.blocks import SeparableConvNormAct
from pytorch_segmentation_tpu_torch.ops.loss import compute_loss
from pytorch_segmentation_tpu_torch.ops.pool import adaptive_avg_pool2d
from pytorch_segmentation_tpu_torch.utils.synthetic import make_synthetic_coco
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, assert_weights_match_jax,
                               jax_train_step, port_trainer_step,
                               train_batch, without_default_init)

torch.set_num_threads(1)

NC, HW = 5, 64
LAYERS = (1, 1, 1, 1)
AUX_WEIGHT = 0.4   # the JAX make_train_step's default, the train CLI's


def jax_fastfcn(**kwargs):
    return JaxPSPNet(jpu=True, **kwargs)


# name -> (registry name, JAX constructor, extra constructor arguments)
CASES = {"pspnet": ("pspnet", JaxPSPNet, {}),
         "pspnet_aux": ("pspnet", JaxPSPNet, {"aux": True}),
         "fastfcn_aux": ("fastfcn", jax_fastfcn, {"aux": True})}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Each case of CASES built once in the module: the parametrized `case`
    and the aux train step share it (and its saved checkpoint)."""
    made = {}

    def get(key):
        if key not in made:
            name, jax_cls, extra = CASES[key]
            made[key] = FamilyCase(name, jax_cls, NC, HW,
                                   tmp_path_factory.mktemp(key),
                                   backbone_layers=LAYERS, **extra)
        return made[key]
    return get


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, cases):
    return cases(request.param)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX module's stride-8 f32 logits [2, 8, 8, NC] (an eval-mode
    forward: the aux head's output is dropped there)."""
    return case.jax_logits()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hw,bins", [(65, (1, 2, 3, 6)), (33, (6,))])
def test_adaptive_avg_pool2d_matches_jax(hw, bins, dtype):
    """torch's adaptive windows and the JAX package's slices: f32 to 1e-6;
    bf16 (both sum in f32 and round the mean once) bit for bit."""
    x = np.random.default_rng(0).standard_normal((2, hw, hw, 8)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x).astype(jnp.float32 if dtype == torch.float32
                               else jnp.bfloat16)
    for b in bins:
        got = adaptive_avg_pool2d(xt.permute(0, 3, 1, 2), (b, b))
        assert got.shape == (2, 8, b, b) and got.dtype == dtype
        got = got.permute(0, 2, 3, 1).float().numpy()
        # one compiled program a bin (eagerly, every window is a program)
        want = np.asarray(jax.jit(jax_adaptive_avg_pool2d, static_argnums=1)(
            xj, (b, b)).astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dilation", [1, 8])
def test_separable_conv_norm_act_matches_jax(dilation):
    """Depthwise 3x3 (dilated) + BN + ReLU, then pointwise 1x1 + BN + ReLU,
    eval mode on carried weights: f32 to 1e-5."""
    block = SeparableConvNormAct(12, 16, 3, dilation=dilation,
                                 dtype=torch.float32).eval()
    assert [n for n, _ in block.named_children()] == ["depthwise",
                                                      "pointwise"]
    assert block.depthwise.conv.groups == 12
    assert block.depthwise.conv.weight.shape == (12, 1, 3, 3)
    sd = seeded_state_dict(block, seed=3, init="uniform")
    block.load_state_dict(sd)
    params, stats = jax_trees_from_state_dict(sd)
    x = np.random.default_rng(4).standard_normal((2, 20, 20, 12)).astype(
        np.float32)
    want = JaxSeparableConvNormAct(16, kernel_size=3, dilation=dilation,
                                   dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_state_dict_equals_jax_export(case):
    assert_weights_match_jax(case)
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (8, True)
    aux = case.kwargs.get("aux", False)
    assert (model.jpu, model.aux) == (case.name == "fastfcn", aux)
    names = set(model.state_dict())
    assert any(n.startswith("aux_conv.") for n in names) == aux
    if model.jpu:
        assert "jpu_dil8.depthwise.conv.weight" in names
        assert model.jpu_dil8.depthwise.conv.dilation == (8, 8)
    assert model.head.conv.in_channels == 4096


@pytest.mark.parametrize("full_res_output,dtype", [
    pytest.param(False, torch.float32, id="False"),
    pytest.param(True, torch.float32, id="True"),
    pytest.param(False, torch.bfloat16, id="bf16")])
def test_forward_matches_jax(case, f32, full_res_output, dtype):
    bf16 = (case.jax_logits(jnp.bfloat16) if dtype == torch.bfloat16
            else None)
    assert_forward_matches_jax(case, full_res_output, dtype, f32, bf16)


def test_make_mask_fn_matches_jax(case, f32):
    assert_mask_fn_matches_jax(case, f32, (80, 72))


def test_aux_head_runs_in_train_mode_only(case):
    """An eval-mode forward returns the logits alone (and the eval and
    serving paths refuse a tuple); a train-mode one of an aux model returns
    (logits, aux logits) at layer 3's stride: 8 for PSPNet, 16 for
    FastFCN."""
    model = case.loaded()
    x = torch.zeros(2, 3, HW, HW)
    with torch.no_grad():
        assert model(x).shape == (2, NC, HW // 8, HW // 8)
        out = model.train()(x)
    if not case.kwargs.get("aux"):
        assert isinstance(out, torch.Tensor)
        return
    stride = 16 if case.name == "fastfcn" else 8
    assert [tuple(o.shape) for o in out] == [(2, NC, HW // 8, HW // 8),
                                             (2, NC, HW // stride,
                                              HW // stride)]
    with pytest.raises(ValueError, match="returned a tuple"):
        nhwc_forward(model)(x.permute(0, 2, 3, 1))


def test_aux_trainer_step_matches_jax(cases, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution PSPNet with its aux head, through the stride-8 twin (the
    main and the aux logits each through the upsample+CE loss), against the
    JAX train step with aux_weight 0.4: the step's loss equals the plain
    compute_loss of the same module's full-resolution logits plus 0.4
    times that of its aux logits (1e-6 relative), and every final tensor
    the JAX step's, at assert_step_matches' tolerances and within 2e-3 of
    the tensor's largest entry."""
    case = cases("pspnet_aux")
    batch = train_batch(case)
    model = case.loaded(full_res_output=True).train()
    with torch.no_grad():
        main, aux = model(torch.from_numpy(batch[0]).permute(0, 3, 1, 2))
    segs = torch.from_numpy(batch[1])
    plain = (compute_loss(main.permute(0, 2, 3, 1), segs)
             + AUX_WEIGHT * compute_loss(aux.permute(0, 2, 3, 1), segs))
    assert main.shape[2:] == (HW, HW) and aux.shape[2:] == (HW // 8, HW // 8)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    np.testing.assert_allclose(loss, float(plain), rtol=1e-6)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            assert (np.abs(got[k] - w).max()
                    <= 2e-3 * np.abs(w).max()), k


def _shallow(name, num_classes, **kwargs):
    """One block a stage; the parameters uninitialised, since every caller
    loads or seeds them all."""
    with without_default_init():
        return build_model(name, num_classes, backbone_layers=LAYERS,
                           **kwargs)


def test_load_model_bundle_drops_the_train_only_head(tmp_path, capsys):
    """A checkpoint with the aux head (and its EMA) loads into a model
    built without it: the head's entries are dropped and named, every other
    entry loads; a key outside the head stays strict."""
    aux_model = _shallow("pspnet", NC, dtype=torch.float32, aux=True)
    sd = seeded_state_dict(aux_model, seed=5)
    path = str(tmp_path / "aux.pt")
    save_checkpoint(path, sd, ema={k: v + 1.0 for k, v in sd.items()
                                   if v.is_floating_point()
                                   and "running" not in k})
    head = sorted(k for k in sd if k.startswith(("aux_conv.", "aux_cls.")))
    assert len(head) == 8
    model = load_model_bundle(_shallow("pspnet", NC, dtype=torch.float32),
                              path, "cpu")
    out = capsys.readouterr().out
    assert f"dropping train-only entries not in the eval model: {head}" in out
    got = model.state_dict()
    assert set(got) == set(sd) - set(head)
    assert all(torch.equal(v, sd[k]) for k, v in got.items())
    ema = load_model_bundle(_shallow("pspnet", NC, dtype=torch.float32),
                            path, "cpu", use_ema=True)
    assert "dropping train-only EMA entries" in capsys.readouterr().out
    assert torch.equal(ema.cls_conv.weight, sd["cls_conv.weight"] + 1.0)
    stray = dict(sd, **{"ppm_conv9.conv.weight": sd["cls_conv.weight"]})
    torch.save({"model": stray}, path)
    with pytest.raises(RuntimeError, match="ppm_conv9"):
        load_model_bundle(_shallow("pspnet", NC, dtype=torch.float32), path,
                          "cpu")


def test_warm_start_from_a_checkpoint_without_the_aux_head(tmp_path):
    """`Trainer(weights=...)` of an aux model from a checkpoint of the same
    family without the head: every checkpoint entry loads, the head keeps
    its seeded start, and the step trains both heads."""
    plain = _shallow("pspnet", NC, dtype=torch.float32)
    sd = seeded_state_dict(plain, seed=6, init="uniform")
    path = str(tmp_path / "plain.pt")
    torch.save({"model": sd}, path)
    model = _shallow("pspnet", NC, dtype=torch.float32, aux=True)
    rng = np.random.default_rng(7)
    batch = (rng.standard_normal((2, HW, HW, 3)).astype(np.float32),
             rng.integers(0, NC, (2, HW, HW)).astype(np.int32))
    trainer = Trainer(model, [(*batch, 2)], weights=path, seed=0, log=False,
                      log_dir=str(tmp_path / "runs"), device="cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    seeded = seeded_state_dict(model, 0, init="train")
    for k, v in start.items():
        want = sd[k] if k in sd else seeded[k]
        assert torch.equal(v, want), k
    assert np.isfinite(trainer.step())
    for name in ("aux_cls.weight", "cls_conv.weight"):
        assert not torch.equal(model.state_dict()[name], start[name]), name


@pytest.mark.parametrize("model", ["unet", "deeplabv3plus", "hrnet", "fpn"])
def test_aux_loss_on_a_family_without_the_head_exits(model):
    with pytest.raises(SystemExit, match=r"--aux-loss is only supported by "
                       r"the pspnet/fastfcn/upernet/bisenetv2/ocrnet/fcn/"
                       r"deeplabv3/danet families"):
        ttrain.main(["data", "--model", model, "--aux-loss", "0.4"],
                    device="cpu")


def test_aux_loss_on_an_unported_family_exits_2(capsys, monkeypatch):
    """The one unported name, maskformer, exits 2 naming its ROADMAP item;
    `--model bisenetv2 --aux-loss` parses, and `main` builds BiSeNetV2 with
    its four booster heads (the run stopped there, before any data is
    read)."""
    with pytest.raises(SystemExit) as err:
        ttrain.parse_args(["data", "--model", "maskformer", "--aux-loss",
                           "0.4"])
    assert err.value.code == 2
    assert ("--model maskformer is not ported yet (ROADMAP queue 1 item 6"
            in capsys.readouterr().err)
    opt = ttrain.parse_args(["data", "--model", "fastfcn", "--aux-loss",
                             "0.4"])
    assert (opt.model, opt.aux_loss) == ("fastfcn", 0.4)
    opt = ttrain.parse_args(["data", "--model", "bisenetv2", "--aux-loss",
                             "0.4"])
    assert (opt.model, opt.aux_loss) == ("bisenetv2", 0.4)
    built = []

    class Stop(Exception):
        pass

    class Data:
        classes = ["background", "a", "b"]

        def __init__(self, *args, **kwargs):
            pass

        def __len__(self):
            return 4

    def build(name, num_classes, **kwargs):
        built.append(build_model(name, num_classes, **kwargs))
        raise Stop

    monkeypatch.setattr(ttrain, "build_model", build)
    monkeypatch.setitem(ttrain.DATASETS, "coco", (Data, "train.json", ""))
    with pytest.raises(Stop):
        ttrain.main(["data", "--model", "bisenetv2", "--dataset", "coco",
                     "--aux-loss", "0.4", "--notest"], device="cpu")
    model, = built
    assert type(model).__name__ == "BiSeNetV2" and model.aux
    assert all(hasattr(model, f"aux{i}_{part}") for i in range(2, 6)
               for part in ("conv", "cls"))


def test_cli_train_aux_then_test_drops_the_head(tmp_path, monkeypatch,
                                                capsys):
    """`train --model pspnet --aux-loss 0.4` (one block a stage) for one
    epoch writes a checkpoint with the head; `test --model pspnet` on it
    builds the model without the head and says what it dropped."""
    for module in (ttrain, ttest):
        monkeypatch.setattr(module, "build_model", _shallow)
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "coco")
    make_synthetic_coco(data, num_train=4, num_val=2, img_size=(80, 60),
                        seed=1, num_classes=3)
    argv = [data, "--model", "pspnet", "--dataset", "coco", "-s", "64", "64",
            "-bs", "2", "-a", "1", "--num-workers", "1", "--aux-loss", "0.4",
            "--epochs", "1"]
    trainer = ttrain.main(argv, device="cpu")
    assert trainer.module.aux and trainer.state.step == 2
    saved = torch.load("weights/last.pt", weights_only=True)["model"]
    assert "aux_cls.weight" in saved
    miou = ttest.main([osp.join(data, "val.json"), "--model", "pspnet",
                       "--weights", "weights/last.pt", "-s", "64", "64",
                       "-bs", "2", "--num-workers", "1"], device="cpu")
    assert 0.0 <= miou <= 1.0
    out = capsys.readouterr().out
    assert "dropping train-only entries not in the eval model: " \
        "['aux_cls.bias', 'aux_cls.weight', 'aux_conv.bn.bias'" in out

