"""PyTorch port: LR-ASPP on MobileNetV3-Large against the JAX package on the
same seeded weights and inputs, on the CPU: hardswish and hardsigmoid in
bf16, the backbone's taps, the weights' mapping, the f32 and bf16
forwards, `make_mask_fn` (stride-8 logits, align_corners=False) and one
`Trainer` step against the JAX train step. 5 classes, 64x64 inputs, batch
2, the published widths and depth (3.2M parameters). Each JAX program is
compiled once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import LRASPP as JaxLRASPP
from pytorch_segmentation_tpu.nn.backbones.mobilenetv3 import (
    hardsigmoid as jax_hardsigmoid)
from pytorch_segmentation_tpu.nn.backbones.mobilenetv3 import (
    hardswish as jax_hardswish)
from pytorch_segmentation_tpu_torch.models import build_model, variant_kwargs
from pytorch_segmentation_tpu_torch.nn.backbones.mobilenetv3 import (
    MobileNetV3, hardsigmoid, hardswish)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, assert_weights_match_jax,
                               jax_train_step, port_trainer_step,
                               train_batch)

torch.set_num_threads(1)

NC, HW = 5, 64


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return FamilyCase("lraspp", JaxLRASPP, NC, HW,
                      tmp_path_factory.mktemp("lraspp"))


@pytest.fixture(scope="module")
def f32(case):
    """The JAX module's stride-8 f32 logits [2, 8, 8, NC]."""
    return case.jax_logits()


@pytest.mark.parametrize("fn,jax_fn", [(hardswish, jax_hardswish),
                                       (hardsigmoid, jax_hardsigmoid)],
                         ids=["hardswish", "hardsigmoid"])
def test_hard_activations_equal_jax_in_bf16(fn, jax_fn):
    """Every bf16 value from -8 to 8 in steps of 1/64 (the clamp's corners
    and the multiply by bf16(1/6), which torch's F.hardswish would round
    otherwise): the JAX expression's bits."""
    x = np.arange(-512, 513, dtype=np.float32) / 64.0
    got = fn(torch.from_numpy(x).to(torch.bfloat16))
    want = jax_fn(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_backbone_taps():
    """Dilated: 16 channels at stride 2, 24 at 4, 40 at 8, 112 and 960 at
    16; the last stage at dilation 2 from block 12; block 0 has no
    expand."""
    model = MobileNetV3(dtype=torch.float32).eval()
    with torch.no_grad():
        taps = model(torch.zeros(1, 3, HW, HW))
    assert [tuple(t.shape[1:]) for t in taps] == [
        (16, 32, 32), (24, 16, 16), (40, 8, 8), (112, 4, 4), (960, 4, 4)]
    assert model.block0.expand is None and model.block1.expand is not None
    assert model.block12.depthwise.conv.stride == (1, 1)
    assert model.block12.depthwise.conv.dilation == (2, 2)
    assert model.block11.depthwise.conv.dilation == (1, 1)
    assert model.block3.se.fc1.out_channels == 24   # 72 // 4 -> 24


def test_state_dict_equals_jax_export(case):
    assert_weights_match_jax(case)
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (8, False)
    assert model.scale_conv.bias is None
    assert sum(p.numel() for p in model.parameters()) == 3218818
    with pytest.raises(ValueError, match="has no variants"):
        variant_kwargs("lraspp", "large")
    with pytest.raises(TypeError):
        build_model("lraspp", NC, aux=True)


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


def test_trainer_step_matches_jax(case, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution LR-ASPP, through its stride-8 twin and the upsample+CE
    loss with align_corners=False, against the JAX train step: the
    squeeze-excite gates, hardswish and the head's sigmoid scale in the
    backward."""
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd,
                        "high_classifier")


def test_trains_after_an_inference_mode_forward():
    """hardswish's constant is a Python float, not a tensor cached under
    whichever mode first made it: a server's inference-mode forward, then
    a train-mode forward and backward in the same process."""
    model = MobileNetV3(dtype=torch.bfloat16)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model.eval()(x)
    model.train()(x)[-1].float().sum().backward()
    assert model.stem.conv.weight.grad is not None
