"""PyTorch port: FCN and DeepLabV3 (the torchvision-zoo families, each with
its nested auxiliary head) against the JAX package on the same seeded
weights and inputs, on the CPU: the weights' mapping, the f32 and bf16
forwards, `make_mask_fn` (stride-8 logits, align_corners=False), one aux
`Trainer` step of each against the JAX train step, and the nested
`aux_head.*` entries that `load_model_bundle` drops. 5 classes, 64x64
inputs, batch 2, one block a stage (`backbone_layers=(1, 1, 1, 1)`) at the
published widths. At 8x8 features DeepLabV3's rates (12, 24, 36) read
only padding off the centre tap, so one more case runs it at rates (1, 2,
3), where every tap reads the map. Each JAX program is compiled once."""

import jax.numpy as jnp
import pytest
import torch

from pytorch_segmentation_tpu.models import FCN as JaxFCN
from pytorch_segmentation_tpu.models import DeepLabV3 as JaxDeepLabV3
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    TRAIN_ONLY_MODULES, load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.models import (MODEL_VARIANTS,
                                                   build_model,
                                                   variant_kwargs)
from pytorch_segmentation_tpu_torch.utils.weights import seeded_state_dict
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, assert_weights_match_jax,
                               jax_train_step, port_trainer_step,
                               train_batch, without_default_init)

torch.set_num_threads(1)

NC, HW = 5, 64
LAYERS = (1, 1, 1, 1)

# name -> (registry name, JAX class, extra constructor arguments)
CASES = {"fcn_aux": ("fcn", JaxFCN, {"aux": True}),
         "deeplabv3_aux": ("deeplabv3", JaxDeepLabV3, {"aux": True})}


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


def test_state_dict_equals_jax_export(case):
    assert_weights_match_jax(case)
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (8, False)
    names = set(model.state_dict())
    aux = case.kwargs.get("aux", False)
    assert ("aux_head.aux_conv.conv.weight" in names) == aux
    assert ("aux_head.aux_cls.bias" in names) == aux
    assert not any(n.startswith(("aux_conv.", "aux_cls.")) for n in names)
    if case.name == "deeplabv3":
        rates = case.kwargs.get("rates", (12, 24, 36))
        assert [getattr(model, f"aspp_b{i}").conv.dilation
                for i in (1, 2, 3)] == [(r, r) for r in rates]
        assert model.aspp_project.conv.in_channels == 1280
        assert model.cls_conv.in_channels == 256
    else:
        assert model.head.conv.in_channels == 2048
        assert model.cls_conv.in_channels == 512


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


@pytest.fixture(scope="module")
def near_rates(tmp_path_factory):
    """DeepLabV3 at rates (1, 2, 3) and its JAX f32 logits."""
    case = FamilyCase("deeplabv3", JaxDeepLabV3, NC, HW,
                      tmp_path_factory.mktemp("deeplabv3_rates123"),
                      backbone_layers=LAYERS, rates=(1, 2, 3))
    return case, case.jax_logits()


@pytest.mark.parametrize("full_res_output", [False, True])
def test_near_rates_forward_matches_jax(near_rates, full_res_output):
    """Every tap of the three dilated branches reads the 8x8 map: f32 to
    1e-4 against the JAX module."""
    case, f32 = near_rates
    assert [case.port_module().aspp_b3.conv.dilation] == [(3, 3)]
    assert_forward_matches_jax(case, full_res_output, torch.float32, f32)


def test_full_res_output_is_8x_the_logits():
    """A 65x65 input gives stride-8 logits of 9x9 and, with
    full_res_output, 72x72 (8 x 9, as the JAX module: not the input's 65),
    upsampled with align_corners=False; the aux head returns in train mode
    only, at stride 8."""
    model = _shallow_fcn(aux=True)
    model.load_state_dict(seeded_state_dict(model, 0, init="uniform"))
    x = torch.randn(2, 3, 65, 65, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        full = model.eval()(x)
        main, aux = model.train()(x)
    assert full.shape == (2, NC, 72, 72)
    assert main.shape == (2, NC, 72, 72) and aux.shape == (2, NC, 9, 9)


@pytest.mark.parametrize("name,jax_cls", [("fcn", JaxFCN),
                                          ("deeplabv3", JaxDeepLabV3)])
def test_aux_trainer_step_matches_jax(name, jax_cls, cases, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution model with its nested aux head, through the stride-8
    twin (the main and the aux logits each through the upsample+CE loss
    with align_corners=False), against the JAX train step with aux_weight
    0.4."""
    case = cases(f"{name}_aux")
    assert case.jax_cls is jax_cls
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert any(k.startswith("aux_head.") for k in want)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")


def _shallow_fcn(**kwargs):
    """FCN at one block a stage, its parameters uninitialised: each caller
    seeds or loads them all."""
    with without_default_init():
        return build_model("fcn", NC, dtype=torch.float32,
                           backbone_layers=LAYERS, **kwargs)


def test_load_model_bundle_drops_the_nested_aux_head(tmp_path, capsys):
    """A checkpoint of FCN with `aux_head.aux_conv.*` / `aux_head.aux_cls.*`
    (and its EMA) loads into FCN built without the head: the nested entries
    are dropped and named, every other entry loads; a stray key stays
    strict."""
    assert {"aux_head", "pam_cls", "cam_cls"} <= set(TRAIN_ONLY_MODULES)
    aux_model = _shallow_fcn(aux=True)
    sd = seeded_state_dict(aux_model, seed=5)
    path = str(tmp_path / "aux.pt")
    save_checkpoint(path, sd, ema={k: v + 1.0 for k, v in sd.items()
                                   if v.is_floating_point()
                                   and "running" not in k})
    head = sorted(k for k in sd if k.startswith("aux_head."))
    assert len(head) == 8
    model = load_model_bundle(_shallow_fcn(), path,
                              "cpu")
    out = capsys.readouterr().out
    assert f"dropping train-only entries not in the eval model: {head}" in out
    got = model.state_dict()
    assert set(got) == set(sd) - set(head)
    assert all(torch.equal(v, sd[k]) for k, v in got.items())
    ema = load_model_bundle(_shallow_fcn(), path,
                            "cpu", use_ema=True)
    assert "dropping train-only EMA entries" in capsys.readouterr().out
    assert torch.equal(ema.cls_conv.weight, sd["cls_conv.weight"] + 1.0)
    stray = dict(sd, **{"head2.conv.weight": sd["cls_conv.weight"]})
    torch.save({"model": stray}, path)
    with pytest.raises(RuntimeError, match="head2"):
        load_model_bundle(_shallow_fcn(), path, "cpu")


@pytest.mark.parametrize("name", ["fcn", "deeplabv3"])
def test_r101_variant(name):
    """`--variant r101` is ResNet-101's (3, 4, 23, 3) blocks, r50 the
    default."""
    assert MODEL_VARIANTS[name] == {
        "r50": {}, "r101": {"backbone_layers": (3, 4, 23, 3)}}
    with torch.device("meta"):   # the structure only
        model = build_model(name, NC, **variant_kwargs(name, "r101"))
        r50 = build_model(name, NC)
    assert hasattr(model.backbone, "layer3_block22")
    assert not hasattr(model.backbone, "layer3_block23")
    assert not hasattr(r50.backbone, "layer3_block6")
