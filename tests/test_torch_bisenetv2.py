"""PyTorch port: BiSeNetV2 (the detail and semantic branches, the
bilateral guided aggregation and the four booster heads) against the JAX
package on the same seeded weights and inputs, on the CPU: the weights'
mapping both ways and against the JAX `convert_named` (the lone `ce_bn`
BatchNorm, which the JAX export cannot map, and the 6x grouped expansion
kernels among them),
the f32 forwards (stride-8 logits and the full-resolution resize), the
bf16 forward, `make_mask_fn`, one aux `Trainer` step (the logits and the
four boosters on the stride-8 grid through the upsample+CE loss) against
the JAX train step of the stride-8 module, the boosters that
`load_model_bundle` drops, and the default widths on the meta device. 5
classes, 64x64 inputs (the semantic branch down to 2x2), batch 2, every
width narrowed. Each JAX program is compiled once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import BiSeNetV2 as JaxBiSeNetV2
from pytorch_segmentation_tpu_torch import inference as tinference
from pytorch_segmentation_tpu_torch import serve as tserve
from pytorch_segmentation_tpu_torch import test as ttest
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    TRAIN_ONLY_MODULES, load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.models import build_model
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches,
                               assert_weights_match_convert_named,
                               jax_train_step, port_trainer_step,
                               train_batch)

torch.set_num_threads(1)

NC, HW = 5, 64
# the semantic branch's last width equals the detail branch's (BGA's
# depthwise conv on the semantic side has groups = the detail width)
SMALL = {"detail_channels": (8, 8, 16), "semantic_channels": (4, 8, 12, 16),
         "head_channels": 32, "aux_channels": (8, 8, 16, 32)}
BOOSTERS = [f"aux{i}_{part}" for i in range(2, 6) for part in ("conv", "cls")]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return FamilyCase("bisenetv2", JaxBiSeNetV2, NC, HW,
                      tmp_path_factory.mktemp("bisenetv2"), aux=True,
                      **SMALL)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX BiSeNetV2's stride-8 f32 logits [2, 8, 8, NC] (an eval-mode
    forward: the boosters' outputs are not returned)."""
    return case.jax_logits()


def test_weights_match_convert_named(case):
    """The lone `ce_bn` maps as a BatchNorm (weight, bias and running
    statistics; seeded as one), and a stride-1 expansion's (3, 3, 1, 6 cin)
    HWIO kernel to (6 cin, 1, 3, 3), output channel j reading input channel
    j // 6."""
    params, stats = assert_weights_match_convert_named(case)
    assert params["ce_bn"] == {"scale": (16,), "bias": (16,)}
    assert stats["ce_bn"] == {"mean": (16,), "var": (16,)}
    assert params["ge3_1"]["dwconv"]["conv"]["kernel"] == (3, 3, 1, 48)
    assert params["ge3_0"]["dwconv1"]["conv"]["kernel"] == (3, 3, 1, 24)
    assert set(BOOSTERS) <= set(params)
    model = case.port_module()
    assert model.ge3_1.dwconv.conv.groups == 8
    assert tuple(model.ge3_1.dwconv.conv.weight.shape) == (48, 1, 3, 3)
    kernel = case.params["ge3_1"]["dwconv"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        case.sd["ge3_1.dwconv.conv.weight"].numpy()[:, 0],
        kernel[:, :, 0].transpose(2, 0, 1))
    assert (model.output_stride, model.up_align_corners) == (8, False)
    for k in ("ce_bn.weight", "ce_bn.running_mean", "ce_bn.running_var"):
        assert k in case.sd
    train = seeded_state_dict(model, seed=0, init="train")
    assert float(train["ce_bn.weight"].min()) == 1.0
    assert float(train["ce_bn.running_var"].min()) == 1.0


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


def test_boosters_run_in_train_mode_only(case):
    """An eval-mode forward returns the logits alone and runs no booster; a
    train-mode one (logits, (aux2, aux3, aux4, aux5)), each booster on the
    logits' grid (stride 8, or the input size with full_res_output). The
    lone `ce_bn` takes its train-mode statistics over the batch."""
    x = torch.randn(2, 3, HW, HW, generator=torch.Generator().manual_seed(0))
    model = case.loaded()
    ran = []
    model.aux3_conv.register_forward_hook(lambda *args: ran.append(1))
    with torch.no_grad():
        assert model(x).shape == (2, NC, HW // 8, HW // 8)
        assert not ran
        out, boosters = model.train()(x)
        full = case.loaded(full_res_output=True).train()
        full_out, full_boosters = full(x)
    assert out.shape == (2, NC, HW // 8, HW // 8)
    assert [tuple(b.shape) for b in boosters] == [tuple(out.shape)] * 4
    assert full_out.shape == (2, NC, HW, HW)
    assert [tuple(b.shape) for b in full_boosters] == [(2, NC, HW, HW)] * 4
    assert int(model.ce_bn.num_batches_tracked) == 1


def test_aux_trainer_step_matches_jax(case, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution BiSeNetV2, through the stride-8 twin (the logits and
    the four boosters, resized onto the stride-8 grid, through the
    upsample+CE loss, the boosters weighted 0.4), against the JAX step of
    the stride-8 module, as the JAX Trainer runs it (the full-resolution
    module resizes the stride-4 booster straight to the input size, another
    function); every booster moves. The second image is brightened by 0.5:
    the lone `ce_bn` normalizes the global means of B = 2 images, and two
    draws of the same noise have means equal to about 1e-3, whose
    difference the normalize divides by about sqrt(eps). From that start
    two f32 runs that sum in another order part by 14% in the joint update
    (the stem's by 15%); from images whose means part, by 0.02%."""
    batch = train_batch(case)
    batch[0][1] += 0.5
    want_loss, want = jax_train_step(case, batch, full_res_output=False)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")
    for i in range(2, 6):
        k = f"aux{i}_cls.weight"
        assert not np.array_equal(got[k], case.sd[k].numpy()), k


def test_load_model_bundle_drops_the_boosters(tmp_path, capsys):
    """A `train --aux-loss` checkpoint loads into BiSeNetV2 built without
    the boosters: exactly the aux2..aux5 entries are dropped and named."""
    assert set(BOOSTERS) <= set(TRAIN_ONLY_MODULES)
    sd = seeded_state_dict(build_model("bisenetv2", NC, dtype=torch.float32,
                                       aux=True, **SMALL), seed=5)
    path = str(tmp_path / "aux.pt")
    save_checkpoint(path, sd)
    heads = sorted(k for k in sd if k.split(".")[0] in BOOSTERS)
    assert len(heads) == 4 * 8   # conv 1 + its BN 5 entries, cls 2
    model = load_model_bundle(build_model("bisenetv2", NC,
                                          dtype=torch.float32, **SMALL),
                              path, "cpu")
    out = capsys.readouterr().out
    assert f"dropping train-only entries not in the eval model: {heads}" in out
    got = model.state_dict()
    assert set(got) == set(sd) - set(heads)
    assert all(torch.equal(v, sd[k]) for k, v in got.items())


def test_default_widths_and_remat():
    """The paper's widths on the meta device, their shapes as the JAX
    module's tree has them; remat=True builds (tests/test_torch_remat.py
    steps it)."""
    with torch.device("meta"):   # the structure only
        model = build_model("bisenetv2", 19, aux=True)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["ge5_3.dwconv.conv.weight"] == (768, 1, 3, 3)
    assert shapes["head.conv.weight"] == (1024, 128, 3, 3)
    assert shapes["aux5_conv.conv.weight"] == (1024, 128, 3, 3)
    assert shapes["aux2_conv.conv.weight"] == (16, 16, 3, 3)
    assert shapes["bga_s_dw.conv.weight"] == (128, 1, 3, 3)
    assert shapes["ce_bn.running_mean"] == (128,)
    params, _ = jax_trees_from_state_dict(
        {k: np.zeros(v, np.float32) for k, v in shapes.items()
         if not k.endswith("num_batches_tracked")})
    assert params["ge4_0"]["short_pw"]["conv"]["kernel"].shape == (1, 1, 32,
                                                                   64)
    with torch.device("meta"):
        assert build_model("bisenetv2", NC, remat=True).remat


CLIS = {"train": ttrain, "test": ttest, "inference": tinference,
        "serve": tserve}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_command_lines_take_the_family(cli, tmp_path):
    """Every command line takes `--model bisenetv2`, and `train` its
    `--aux-loss`."""
    weights = tmp_path / "w.pt"
    weights.touch()
    argv = {"train": ["data"], "test": ["val.json"],
            "inference": ["in", "out"],
            "serve": ["--weights", str(weights)]}[cli]
    argv += ["--model", "bisenetv2"]
    if cli == "train":
        argv += ["--aux-loss", "0.4"]
    opt = CLIS[cli].parse_args(argv)
    assert opt.model == "bisenetv2"
    assert cli != "train" or opt.aux_loss == 0.4
