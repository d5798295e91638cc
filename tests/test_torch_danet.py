"""PyTorch port: DANet (position and channel attention, with its two branch
classifiers as auxiliary heads) against the JAX package on the same seeded
weights and inputs, on the CPU: the learned residual gates' `scale` leaf,
the weights' mapping, the f32 and bf16 forwards, `make_mask_fn` (stride-8
logits, align_corners=False), one aux `Trainer` step against the JAX train
step (three heads: the fused logits, `pam_cls` and `cam_cls`), and the
train-only heads that `load_model_bundle` drops. 5 classes, 64x64 inputs,
batch 2, one block a stage (`backbone_layers=(1, 1, 1, 1)`), `channels=64`
(8-channel query and key). The gates start non-zero (`init="uniform"`):
with the JAX start of 0 both attention branches add nothing, and a wrong
PAM or CAM would go unseen. Each JAX program is compiled once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import DANet as JaxDANet
from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.models import (MODEL_VARIANTS,
                                                   build_model,
                                                   variant_kwargs)
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict, state_dict_from_jax)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, jax_train_step,
                               port_trainer_step, train_batch)

torch.set_num_threads(1)

NC, HW = 5, 64
SMALL = {"backbone_layers": (1, 1, 1, 1), "channels": 64}
GATES = ("pam_gamma.scale", "cam_gamma.scale")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return FamilyCase("danet", JaxDANet, NC, HW,
                      tmp_path_factory.mktemp("danet"), aux=True, **SMALL)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX module's stride-8 f32 logits [2, 8, 8, NC] (an eval-mode
    forward: the branch classifiers' outputs are dropped there)."""
    return case.jax_logits()


def test_scale_leaf_round_trip():
    """A `scale` leaf outside a BN keeps its name both ways and its value;
    a BN's scale still becomes `weight`."""
    params = {"pam_gamma": {"scale": np.array([0.75], np.float32)},
              "head": {"bn": {"scale": np.ones(3, np.float32),
                              "bias": np.zeros(3, np.float32)}}}
    stats = {"head": {"bn": {"mean": np.zeros(3, np.float32),
                             "var": np.ones(3, np.float32)}}}
    sd = state_dict_from_jax(params, stats)
    assert sd["pam_gamma.scale"].shape == (1,)
    assert float(sd["pam_gamma.scale"][0]) == 0.75
    assert "head.bn.weight" in sd and "head.bn.scale" not in sd
    back, back_stats = jax_trees_from_state_dict(sd)
    assert back["pam_gamma"]["scale"].dtype == np.float32
    np.testing.assert_array_equal(back["pam_gamma"]["scale"], [0.75])
    np.testing.assert_array_equal(back["head"]["bn"]["scale"], np.ones(3))
    assert back_stats["head"]["bn"].keys() == {"mean", "var"}


@pytest.mark.parametrize("init", ["serve", "uniform", "train"])
def test_seeded_gates(init):
    """'serve' and 'uniform' start the gates at 0.5..1.5, so both branches
    count; 'train' at 0, the JAX package's start."""
    model = build_model("danet", NC, dtype=torch.float32, **SMALL)
    sd = seeded_state_dict(model, seed=0, init=init)
    model.load_state_dict(sd)
    for name in GATES:
        assert sd[name].shape == (1,) and sd[name].dtype == torch.float32
        if init == "train":
            assert float(sd[name]) == 0.0
        else:
            assert 0.5 <= float(sd[name]) <= 1.5


def test_state_dict_matches_jax_init_tree(case):
    """The JAX module's parameter and statistics trees have the shapes of
    the trees made from the port's state_dict, and the port's
    `state_dict_from_jax` of them is the port's state_dict again: key for
    key, bit for bit, a strict load (the JAX package's own export cannot
    map `_Scale`)."""
    params_shapes, stats_shapes = case.jax_shapes()
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    (case.params, case.stats))
    assert shapes == (params_shapes, stats_shapes)
    assert params_shapes["pam_gamma"] == {"scale": (1,)}
    assert {"pam_cls", "cam_cls"} <= set(params_shapes)
    got = state_dict_from_jax(case.params, case.stats)
    model = case.port_module()
    assert set(got) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()},
                          strict=True)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), np.asarray(case.sd[k])), k
    assert all(float(case.sd[g]) >= 0.5 for g in GATES)
    assert (model.output_stride, model.up_align_corners) == (8, False)
    assert model.pam_query.out_channels == model.pam_key.out_channels == 8


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


@pytest.mark.parametrize("gate", GATES)
def test_each_attention_branch_counts(case, gate):
    """With one gate at 0 the logits move by more than 1% of their
    largest: the branch that gate scales reaches the output."""
    model = case.loaded()
    x = normalize_images(torch.from_numpy(case.images)).permute(0, 3, 1, 2)
    with torch.no_grad():
        gated = model(x)
        model.get_submodule(gate.split(".")[0]).scale.zero_()
        off = model(x)
    assert (off - gated).abs().max() > 0.01 * gated.abs().max()


def test_aux_heads_run_in_train_mode_only(case):
    """An eval-mode forward returns the logits alone; a train-mode one
    returns (logits, (pam logits, cam logits)), the heads at stride 8."""
    model = case.loaded()
    x = torch.zeros(2, 3, HW, HW)
    with torch.no_grad():
        assert model(x).shape == (2, NC, HW // 8, HW // 8)
        out, heads = model.train()(x)
    assert out.shape == (2, NC, HW // 8, HW // 8)
    assert [tuple(h.shape) for h in heads] == [(2, NC, HW // 8, HW // 8)] * 2


def test_aux_trainer_step_matches_jax(case, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution DANet, through the stride-8 twin (the fused logits and
    both branch heads through the upsample+CE loss, the heads weighted
    0.4), against the JAX train step; the gates move."""
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")
    for g in GATES:
        assert got[g] != case.sd[g].numpy(), g


def test_load_model_bundle_drops_the_branch_heads(tmp_path, capsys):
    """A checkpoint with `pam_cls.*` and `cam_cls.*` loads into DANet built
    without them: the four entries are dropped and named."""
    aux_model = build_model("danet", NC, dtype=torch.float32, aux=True,
                            **SMALL)
    sd = seeded_state_dict(aux_model, seed=5)
    path = str(tmp_path / "aux.pt")
    save_checkpoint(path, sd)
    heads = sorted(k for k in sd if k.startswith(("pam_cls.", "cam_cls.")))
    assert heads == ["cam_cls.bias", "cam_cls.weight", "pam_cls.bias",
                     "pam_cls.weight"]
    model = load_model_bundle(build_model("danet", NC, dtype=torch.float32,
                                          **SMALL), path, "cpu")
    out = capsys.readouterr().out
    assert f"dropping train-only entries not in the eval model: {heads}" in out
    got = model.state_dict()
    assert set(got) == set(sd) - set(heads)
    assert all(torch.equal(v, sd[k]) for k, v in got.items())


def test_r101_variant():
    assert MODEL_VARIANTS["danet"] == {
        "r50": {}, "r101": {"backbone_layers": (3, 4, 23, 3)}}
    with torch.device("meta"):   # the structure only
        model = build_model("danet", NC, **variant_kwargs("danet", "r101"))
    assert hasattr(model.backbone, "layer3_block22")
    assert model.channels == 512 and model.pam_query.out_channels == 64
