"""PyTorch port: semantic FPN (ResNet-50 and ResNet-34) against the JAX
package on the same seeded weights and inputs, on the CPU: the basic-block
ResNet-34 tree, the weights' mapping, the f32 and bf16 forwards,
`make_mask_fn` (stride-4 logits, align_corners=False), one `Trainer` step
and the `--variant` of the command lines. 5 classes, 64x64 inputs, batch 2,
one block a stage (`backbone_layers=(1, 1, 1, 1)`) at the published widths.
Each JAX program is compiled once."""

import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_segmentation_tpu.models import FPN as JaxFPN
from pytorch_segmentation_tpu.models import (
    MODEL_VARIANTS as JAX_MODEL_VARIANTS)
from pytorch_segmentation_tpu.nn.backbones.resnet import ResNet as JaxResNet
from pytorch_segmentation_tpu.nn.backbones.resnet import (
    resnet34_cfg as jax_resnet34_cfg)
from pytorch_segmentation_tpu.nn.backbones.resnet import (
    resnet50_cfg as jax_resnet50_cfg)
from pytorch_segmentation_tpu_torch import inference as tinference
from pytorch_segmentation_tpu_torch import serve as tserve
from pytorch_segmentation_tpu_torch import test as ttest
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.models import (MODEL_VARIANTS,
                                                   build_model,
                                                   variant_kwargs)
from pytorch_segmentation_tpu_torch.nn.backbones.resnet import (
    BasicBlock, ResNet, resnet34_cfg, resnet50_cfg)
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, assert_weights_match_jax,
                               jax_train_step, port_trainer_step,
                               train_batch)

torch.set_num_threads(1)

NC, HW = 5, 64
BLOCKS = {"r50": "bottleneck", "r34": "basic"}


@pytest.fixture(scope="module", params=sorted(BLOCKS))
def case(request, tmp_path_factory):
    block = BLOCKS[request.param]
    return FamilyCase("fpn", JaxFPN, NC, HW,
                      tmp_path_factory.mktemp(f"fpn_{request.param}"),
                      backbone_layers=(1, 1, 1, 1), block=block)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX FPN's stride-4 f32 logits [2, 16, 16, NC] (twice: no probe,
    the bf16 bounds are held at the logits)."""
    return case.jax_logits()


@pytest.mark.parametrize("cfg,jax_cfg", [
    pytest.param(resnet34_cfg, jax_resnet34_cfg, id="resnet34"),
    pytest.param(resnet50_cfg, jax_resnet50_cfg, id="resnet50")])
def test_resnet_cfg_tree_matches_jax(cfg, jax_cfg):
    """The port's full-depth ResNet of each config has the JAX module's
    parameter and statistics trees, name for name and shape for shape."""
    model = ResNet(**cfg(dtype=torch.float32))
    params, stats = jax_trees_from_state_dict(model.state_dict())
    variables = jax.eval_shape(
        lambda k, x: JaxResNet(**jax_cfg(dtype=jnp.float32)).init(
            {"params": k}, x, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3), jnp.float32))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), variables)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), params) == \
        shapes["params"]
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), stats) == \
        shapes["batch_stats"]
    blocks = [m for m in model.modules() if isinstance(m, BasicBlock)]
    assert len(blocks) == (16 if cfg is resnet34_cfg else 0)
    assert model.out_channels == (512 if cfg is resnet34_cfg else 2048)


def test_state_dict_equals_jax_export(case):
    assert_weights_match_jax(case)
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (4, False)
    assert model.block == case.kwargs["block"]
    names = {n for n, _ in model.named_children()}
    assert names == {"backbone", "cls_conv", "lat0", "lat1", "lat2", "lat3",
                     "smooth0", "smooth1", "smooth2", "smooth3", "head0_0",
                     "head1_0", "head2_0", "head2_1", "head3_0", "head3_1",
                     "head3_2"}
    assert all(getattr(model, f"lat{i}").activate is None for i in range(4))


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


def test_trainer_step_matches_jax(tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution FPN-R34 (one block a stage), through its stride-4 twin
    and the upsample+CE loss with align_corners=False, against the JAX train
    step."""
    case = FamilyCase("fpn", JaxFPN, NC, HW, tmp_path,
                      backbone_layers=(1, 1, 1, 1), block="basic")
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")


def test_variants_are_the_jax_packages():
    """The port's variants are the JAX package's, family for family, for
    every ported family that has variants."""
    assert MODEL_VARIANTS["fpn"] == {
        "r50": {}, "r34": {"block": "basic",
                           "backbone_layers": (3, 4, 6, 3)}}
    assert MODEL_VARIANTS == {name: JAX_MODEL_VARIANTS[name] for name in
                              ("danet", "deeplabv3", "fcn", "fpn",
                               "maskformer", "ocrnet", "segformer",
                               "segmenter", "segnext", "upernet")}
    model = build_model("fpn", NC, **variant_kwargs("fpn", "R34"))
    assert model.block == "basic" and model.backbone.out_channels == 512
    assert variant_kwargs("fpn", "") == {}
    with pytest.raises(ValueError, match=r"unknown fpn variant 'r18'; "
                       r"available: \['r34', 'r50'\]"):
        variant_kwargs("fpn", "r18")
    with pytest.raises(ValueError, match=r"model 'pspnet' has no variants "
                       r"\(families with variants: \['danet', 'deeplabv3', "
                       r"'fcn', 'fpn', 'maskformer', 'ocrnet', 'segformer', "
                       r"'segmenter', 'segnext', 'upernet'\]\)"):
        variant_kwargs("pspnet", "r50")
    # the last family ported, maskformer: its r50 and tiny resolve
    assert variant_kwargs("maskformer", "r50") == {}
    assert variant_kwargs("maskformer", "tiny") == \
        JAX_MODEL_VARIANTS["maskformer"]["tiny"]


def _argv(cli, tmp_path, *extra):
    weights = tmp_path / "w.pt"
    weights.touch()
    return {"train": ["data"], "test": ["val.json"],
            "inference": ["in", "out"],
            "serve": ["--weights", str(weights)]}[cli] + list(extra)


@pytest.mark.parametrize("cli", ["train", "test", "inference", "serve"])
def test_cli_takes_the_fpn_variant(cli, tmp_path, capsys):
    """Each command line takes `--model fpn --variant r34` (serve's
    `--variant` is new); an unknown variant, or one for a family without
    variants, exits 2 with the choices."""
    module = {"train": ttrain, "test": ttest, "inference": tinference,
              "serve": tserve}[cli]
    opt = module.parse_args(_argv(cli, tmp_path, "--model", "fpn",
                                  "--variant", "r34"))
    assert (opt.model, opt.variant) == ("fpn", "r34")
    for argv in (_argv(cli, tmp_path, "--model", "fpn", "--variant", "r18"),
                 _argv(cli, tmp_path, "--model", "hrnet", "--variant",
                       "r34")):
        with pytest.raises(SystemExit) as err:
            module.parse_args(argv)
        assert err.value.code == 2
    err = capsys.readouterr().err
    assert "unknown fpn variant 'r18'; available: ['r34', 'r50']" in err
    assert "model 'hrnet' has no variants" in err
