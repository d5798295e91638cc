"""PyTorch port: OCRNet (the object-contextual head over HRNet's feature
output) against the JAX package on the same seeded weights and inputs, on
the CPU: the weights' mapping both ways, against the JAX export and its
`convert_named` (the region tensor's 1x1 ConvNormActs among them), the f32
forwards (stride-4 logits and the full-resolution resize), the bf16
forward, `make_mask_fn`, one aux `Trainer` step against the JAX train step
(the logits and the soft-region logits, both at stride 4, through the
upsample+CE loss with align_corners=False), the region heads that a
checkpoint always keeps, and every variant on the meta device. 5 classes,
64x64 inputs, batch 2, HRNet at `base_channels=8` (120 feature channels),
`ocr_channels=32`, `key_channels=16`. Each JAX program is compiled once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import (
    MODEL_VARIANTS as JAX_MODEL_VARIANTS)
from pytorch_segmentation_tpu.models import OCRNet as JaxOCRNet
from pytorch_segmentation_tpu_torch import inference as tinference
from pytorch_segmentation_tpu_torch import serve as tserve
from pytorch_segmentation_tpu_torch import test as ttest
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.models import (MODEL_VARIANTS,
                                                   build_model,
                                                   variant_kwargs)
from pytorch_segmentation_tpu_torch.utils.weights import seeded_state_dict
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, assert_weights_match_jax,
                               assert_weights_match_convert_named,
                               jax_train_step, port_trainer_step,
                               train_batch)

torch.set_num_threads(1)

NC, HW = 5, 64
SMALL = {"base_channels": 8, "ocr_channels": 32, "key_channels": 16}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The bf16 mean bound at the logits is HRNet's, 0.47 of the bf16 error
    (tests/test_torch_hrnet.py): one-ulp roundings that flip between the
    two packages' convolution orders in the stem cascade through the
    branches. On these images the backbone's features read 0.41 of their
    bf16 error, the OCR head's region products (key1, value, out_project)
    0.19, 0.10 and 0.006, and the logits 0.44; on another draw of images
    (seed 2) no rounding flips and the features are equal bit for bit."""
    return FamilyCase("ocrnet", JaxOCRNet, NC, HW,
                      tmp_path_factory.mktemp("ocrnet"),
                      logits_mean_bound=0.47, aux=True, **SMALL)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX OCRNet's stride-4 f32 logits [2, 16, 16, NC] (an eval-mode
    forward: the region logits weight the gather and are not returned)."""
    return case.jax_logits()


def test_weights_match_jax_export_and_convert_named(case):
    assert_weights_match_jax(case)
    params, stats = assert_weights_match_convert_named(case)
    assert params["aux_cls"]["kernel"] == (1, 1, 120, NC)
    assert params["aux_conv"]["conv"]["kernel"] == (1, 1, 120, 120)
    assert stats["key0"]["bn"]["mean"] == (16,)
    assert "final_layer" not in params["backbone"]
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (4, False)
    assert model.backbone.out_channels == 8 + 16 + 32 + 64


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


def test_region_heads_return_in_train_mode_only(case):
    """An eval-mode forward returns the logits alone; a train-mode one with
    aux (logits, region logits), both at stride 4, or both at the input
    size with full_res_output. The region tensor's BatchNorm takes its
    train-mode statistics over the batch and the K regions."""
    x = torch.zeros(2, 3, HW, HW)
    model = case.loaded()
    with torch.no_grad():
        assert model(x).shape == (2, NC, HW // 4, HW // 4)
        out, regions = model.train()(x)
        assert out.shape == regions.shape == (2, NC, HW // 4, HW // 4)
        full = case.loaded(full_res_output=True).train()
        assert [tuple(t.shape) for t in full(x)] == [(2, NC, HW, HW)] * 2
    assert int(model.key0.bn.num_batches_tracked) == 1


def test_aux_trainer_step_matches_jax(tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution OCRNet, through the stride-4 twin (the logits and the
    region logits through the upsample+CE loss, the regions weighted 0.4),
    against the JAX train step; the region head moves. HRNet at two stages
    (`num_branches_list=(2, 3)`, 56 feature channels), where the JAX
    gradient compiles in a third of the time of the full depth."""
    case = FamilyCase("ocrnet", JaxOCRNet, NC, HW, tmp_path, aux=True,
                      num_branches_list=(2, 3), **SMALL)
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")
    assert not np.array_equal(got["aux_cls.weight"],
                              case.sd["aux_cls.weight"].numpy())


def test_load_model_bundle_keeps_the_region_heads(tmp_path, capsys):
    """A `train --aux-loss` checkpoint of OCRNet loads into OCRNet built
    without aux with nothing dropped: the region heads are in every
    OCRNet."""
    sd = seeded_state_dict(build_model("ocrnet", NC, dtype=torch.float32,
                                       aux=True, **SMALL), seed=5)
    path = str(tmp_path / "aux.pt")
    save_checkpoint(path, sd)
    model = load_model_bundle(build_model("ocrnet", NC, dtype=torch.float32,
                                          **SMALL), path, "cpu")
    assert "dropping" not in capsys.readouterr().out
    got = model.state_dict()
    assert set(got) == set(sd) and "aux_cls.weight" in got
    assert all(torch.equal(v, sd[k]) for k, v in got.items())


@pytest.mark.parametrize("variant,width", [("w18", 18), ("w32", 32),
                                           ("w48", 48)])
def test_variants(variant, width):
    """The JAX package's HRNet widths; each built on the meta device: the
    feature concat of its four branches, 512 / 256 OCR channels."""
    assert MODEL_VARIANTS["ocrnet"] == JAX_MODEL_VARIANTS["ocrnet"]
    with torch.device("meta"):   # the structure only
        model = build_model("ocrnet", 21, **variant_kwargs("ocrnet",
                                                           variant))
    assert model.backbone.out_channels == 15 * width
    assert model.aux_conv.conv.out_channels == 15 * width
    assert model.bottleneck.conv.out_channels == 512
    assert model.query1.conv.out_channels == 256


CLIS = {"train": ttrain, "test": ttest, "inference": tinference,
        "serve": tserve}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_command_lines_take_the_family(cli, tmp_path):
    """Every command line takes `--model ocrnet --variant w48`, and `train`
    its `--aux-loss`."""
    weights = tmp_path / "w.pt"
    weights.touch()
    argv = {"train": ["data"], "test": ["val.json"],
            "inference": ["in", "out"],
            "serve": ["--weights", str(weights)]}[cli]
    argv += ["--model", "ocrnet", "--variant", "w48"]
    if cli == "train":
        argv += ["--aux-loss", "0.4"]
    opt = CLIS[cli].parse_args(argv)
    assert (opt.model, opt.variant) == ("ocrnet", "w48")
    assert cli != "train" or opt.aux_loss == 0.4
