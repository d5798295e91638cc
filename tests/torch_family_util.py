"""Shared pieces of the PyTorch port's CPU tests of the model families
(tests/test_torch_<family>.py): the JAX module and the port's module on
the same seeded weights, each JAX program compiled once."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pytorch_segmentation_tpu.engine import steps as jsteps
from pytorch_segmentation_tpu.ops.loss import compute_loss as jax_compute_loss
from pytorch_segmentation_tpu.ops.resize import resize_bilinear as jax_resize
from pytorch_segmentation_tpu.utils.port_torch import (convert_named,
                                                       export_torch_state_dict)
from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.inference import make_mask_fn
from pytorch_segmentation_tpu_torch.models import (build_model,
                                                   without_default_init)
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, load_state, seeded_state_dict,
    state_dict_from_jax)
from torch_port_util import assert_masks_agree

LR, MOMENTUM = 1e-3, 0.9
# XLA compiles for the CPU without LLVM's optimisation passes in half the
# time; the programs' HLO is the same (an f32 loss moves by 1e-7 relative)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _shape_tree(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


class FamilyCase:
    """One family at test size: `jax_module(full_res_output, dtype)` and
    `port_module(full_res_output, dtype)` build the two sides (the same
    constructor arguments), `hw` is the square input size. The bf16 mean
    bound is held at the logits, as `logits_mean_bound` of the bf16 error
    there, and, where `probe` (a top-level submodule's name and an index
    into its output sequence) names an activation, at 0.4 of the bf16 error
    at that activation as well. Every bf16 logit is held within 2% of the
    largest, or, given `logits_max_bound`, within that multiple of the
    largest bf16 error at the logits. `f32_logits`: the logits are f32
    whatever the compute dtype (Segmenter's)."""

    def __init__(self, name, jax_cls, num_classes, hw, tmp_dir, probe=None,
                 logits_mean_bound=0.4, logits_max_bound=None,
                 f32_logits=False, **kwargs):
        self.name, self.jax_cls, self.nc, self.hw = name, jax_cls, num_classes, hw
        self.probe, self.logits_mean_bound = probe, logits_mean_bound
        self.logits_max_bound, self.f32_logits = logits_max_bound, f32_logits
        self.kwargs = kwargs
        # the seeded start: conv kernels uniform in +-1/sqrt(fan_in), BN
        # affines and statistics non-trivial (the f32 logits stay near 1, so
        # rtol = atol = 1e-4 holds everywhere; well-conditioned gradients)
        self.sd = seeded_state_dict(self.port_module(), seed=0,
                                    init="uniform")
        self.params, self.stats = jax_trees_from_state_dict(self.sd)
        self.path = str(tmp_dir / f"{name}.pt")
        torch.save({"model": self.sd}, self.path)
        self.images = np.random.default_rng(1).integers(
            0, 256, (2, hw, hw, 3), dtype=np.uint8)

    def jax_module(self, full_res_output=False, dtype=jnp.float32):
        return self.jax_cls(num_classes=self.nc, dtype=dtype,
                            full_res_output=full_res_output, **self.kwargs)

    def port_module(self, full_res_output=False, dtype=torch.float32):
        """The port's module, its parameters uninitialised: load them."""
        with without_default_init():
            return build_model(self.name, self.nc, dtype=dtype,
                               full_res_output=full_res_output, **self.kwargs)

    @functools.cached_property
    def saved_state(self):
        """The state_dict of `path`, read through `load_state` once."""
        return load_state(self.path)

    def loaded(self, full_res_output=False, dtype=torch.float32):
        model = self.port_module(full_res_output, dtype)
        model.load_state_dict(self.saved_state, strict=True)
        return model.eval()

    def jax_shapes(self):
        """The JAX module's (params, batch_stats) shape trees, traced, not
        run."""
        variables = jax.eval_shape(
            lambda k, x: self.jax_module().init({"params": k}, x,
                                                train=False),
            jax.random.PRNGKey(0),
            jnp.zeros((1, self.hw, self.hw, 3), jnp.float32))
        return (jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                       variables["params"]),
                jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                       variables.get("batch_stats", {})))

    def jax_logits(self, dtype=jnp.float32):
        """The JAX module's low-resolution logits on `images` (NHWC f32)
        and the `probe` activation (the logits without one)."""
        x = normalize_images(torch.from_numpy(self.images)).numpy()
        module = self.jax_module(False, dtype)
        name, index = self.probe or ("", 0)

        def run(v, x):
            return module.apply(
                v, x, train=False, mutable=["intermediates"],
                capture_intermediates=lambda mdl, _: mdl.name == name)

        args = ({"params": self.params, "batch_stats": self.stats}, x)
        logits, state = jax.jit(run).lower(*args).compile(
            compiler_options=FAST_COMPILE)(*args)
        assert logits.dtype == (jnp.float32 if self.f32_logits else dtype)
        inner = (state["intermediates"][name]["__call__"][0][index]
                 if self.probe else logits)
        return (np.asarray(logits.astype(jnp.float32)),
                np.asarray(inner.astype(jnp.float32)))

    def port_logits(self, full_res_output=False, dtype=torch.float32):
        """The port's logits and `probe` activation (NHWC f32)."""
        model = self.loaded(full_res_output, dtype)
        inner = []
        if self.probe:
            name, index = self.probe
            getattr(model, name).register_forward_hook(
                lambda mod, args, out: inner.append(out[index]))
        with torch.inference_mode():
            got = model(normalize_images(torch.from_numpy(self.images))
                        .permute(0, 3, 1, 2))
        assert got.dtype == (torch.float32 if self.f32_logits else dtype)
        inner = inner[0] if inner else got
        return (got.permute(0, 2, 3, 1).float().numpy(),
                inner.permute(0, 2, 3, 1).float().numpy())


def assert_weights_match_jax(case):
    """The JAX module's shape trees equal those of the trees made from the
    port's state_dict; the port's `state_dict_from_jax` equals the JAX
    package's `export_torch_state_dict` and loads strictly."""
    params_shapes, stats_shapes = case.jax_shapes()
    assert _shape_tree(case.params) == params_shapes
    assert _shape_tree(case.stats) == stats_shapes
    got = state_dict_from_jax(case.params, case.stats)
    want = export_torch_state_dict(case.params, case.stats)
    assert got.keys() == want.keys()   # the JAX export walks sorted trees
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    model = case.port_module()
    assert set(got) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()},
                          strict=True)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), np.asarray(case.sd[k])), k


def assert_forward_matches_jax(case, full_res_output, dtype, f32, bf16=None):
    """The port's forward against the JAX module's: `f32` (and `bf16`) are
    `case.jax_logits()` of that dtype; the full-resolution reference is the
    JAX module's own last op on the logits, the bilinear resize with the
    model's `up_align_corners`. f32 within rtol = atol = 1e-4. bf16 at the
    bounds of tests/test_torch_slice.py: every logit within 2% of the
    largest, the mean difference within `case.logits_mean_bound` of the
    mean bf16 error at the logits and within 0.4 of it at the probe (what a
    cast moved from where the JAX module puts it would exceed), and the
    masks of `make_mask_fn` by the top-2-gap rule. (`case.logits_max_bound`
    replaces the 2% rule, as a multiple of the largest bf16 error.)"""
    align = case.jax_module().up_align_corners
    # the port's stride, held to the JAX logits' size below (the JAX
    # Segmenter has no `output_stride` field)
    stride = case.port_module().output_stride
    want, want_inner = f32 if dtype == torch.float32 else bf16
    if full_res_output:
        want = np.asarray(jax_resize(jnp.asarray(want), (case.hw, case.hw),
                                     align_corners=align))
    got, got_inner = case.port_logits(full_res_output, dtype)
    low = case.hw // stride
    assert got.shape == want.shape == ((2, case.hw, case.hw, case.nc)
                                       if full_res_output
                                       else (2, low, low, case.nc))
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    diff = np.abs(got - want)
    if case.logits_max_bound is None:
        assert diff.max() <= 0.02 * np.abs(want).max(), diff.max()
    else:
        assert diff.max() <= case.logits_max_bound * np.abs(
            want - f32[0]).max(), (diff.max(), np.abs(want - f32[0]).max())
    bf16_error = np.abs(want - f32[0]).mean()
    assert diff.mean() <= case.logits_mean_bound * bf16_error, (
        diff.mean(), bf16_error)
    if case.probe:
        inner_diff = np.abs(got_inner - want_inner).mean()
        bf16_error = np.abs(want_inner - f32[1]).mean()
        assert inner_diff <= 0.4 * bf16_error, (inner_diff, bf16_error)
    up = np.asarray(jax_resize(jnp.asarray(want), (case.hw, case.hw),
                               align_corners=align))
    got_mask = make_mask_fn(case.loaded(False, dtype))(case.images)
    assert_masks_agree(got_mask.numpy(), up.argmax(-1), up,
                       gap=2 * float(diff.max()) + 1e-4, agreement=0.99)


def assert_mask_fn_matches_jax(case, f32, out_hw):
    """`make_mask_fn` (f32, the model's own align) against the argmax of
    the JAX logits upsampled in f32: what the JAX `make_mask_fn` computes
    off the TPU."""
    align = case.jax_module().up_align_corners
    out_hw = out_hw or (case.hw, case.hw)
    up = np.asarray(jax_resize(jnp.asarray(f32[0]), out_hw,
                               align_corners=align))
    got = make_mask_fn(case.loaded(), out_hw=out_hw)(case.images)
    assert got.dtype == torch.int32
    assert_masks_agree(got.numpy(), up.argmax(-1), up)


def assert_weights_match_convert_named(case):
    """The JAX module's shape trees are those of the trees made from the
    port's state_dict; `jax_trees_from_state_dict` equals the JAX package's
    `convert_named` on every leaf, and `state_dict_from_jax` gives the
    state_dict back bit for bit and loads strictly."""
    params_shapes, stats_shapes = case.jax_shapes()
    assert _shape_tree(case.params) == params_shapes
    assert _shape_tree(case.stats) == stats_shapes
    want = convert_named({k: v.numpy() for k, v in case.sd.items()})
    for got_tree, want_tree in zip((case.params, case.stats), want):
        flat_got = jax.tree_util.tree_flatten_with_path(got_tree)[0]
        flat_want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, g), (_, w) in zip(flat_got, flat_want):
            assert g.dtype == w.dtype and np.array_equal(g, w), path
    back = state_dict_from_jax(case.params, case.stats)
    assert set(back) == set(case.sd)
    for k, v in case.sd.items():
        assert np.array_equal(back[k], v.numpy()), k
    model = case.port_module()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()},
                          strict=True)
    return params_shapes, stats_shapes


def numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def train_batch(case, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, case.hw, case.hw, 3)).astype(np.float32),
            rng.integers(0, case.nc, (2, case.hw, case.hw)).astype(np.int32))


def jax_train_step(case, batch, full_res_output=True, loss_fn=None):
    """One SGD-momentum step of the JAX package on the full-resolution
    module with compute_loss (its default step), whose resize to the
    labels takes the module's `up_align_corners`, as the JAX Trainer's
    deferred upsample does (`make_loss_fn(align_corners=...)`): an aux head
    left at low resolution upsamples as the main logits do. Returns the
    loss and the final state as the port's state_dict.
    `full_res_output=False` steps the low-resolution module, as the JAX
    Trainer does: where a model resizes its aux heads onto the main
    logits' grid (BiSeNetV2's boosters), that grid is the loss's input.
    `loss_fn` replaces compute_loss (MaskFormer's set criterion)."""
    module = case.jax_module(full_res_output=full_res_output)
    tx = optax.sgd(LR, momentum=MOMENTUM)
    params = jax.tree.map(jnp.asarray, case.params)
    state = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, case.stats),
        # one program: eager, optax's init compiles a zeros per shape
        opt_state=jax.jit(tx.init)(params), tx=tx, apply_fn=module.apply,
        grad_acc=None, micro_step=jnp.zeros((), jnp.int32), ema_params=None)
    step = jsteps.make_train_step(loss_fn=loss_fn or functools.partial(
        jax_compute_loss, align_corners=module.up_align_corners),
        donate=False)
    args = (state, jnp.asarray(batch[0]), jnp.asarray(batch[1]))
    state, loss = step.lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    return float(loss), state_dict_from_jax(numpy_tree(state.params),
                                            numpy_tree(state.batch_stats))


def port_trainer_step(case, batch, tmp_dir):
    """One `Trainer(device="cpu")` step of the full-resolution model from
    the seeded start: the deferred upsample (its stride-`output_stride`
    twin through make_loss_fn) -> (loss, state_dict)."""
    model = case.port_module(full_res_output=True)
    trainer = Trainer(model, [(*batch, len(batch[0]))], lr=LR,
                      momentum=MOMENTUM, weights=case.path, log=False,
                      log_dir=str(tmp_dir / f"runs_{case.name}"),
                      device="cpu")
    assert trainer._train_module.full_res_output is False
    assert trainer._train_module.up_align_corners == \
        case.jax_module().up_align_corners
    loss = trainer.step()
    assert trainer.state.step == 1
    return loss, {k: v.detach().numpy() for k, v in
                  model.state_dict().items()}


def assert_step_matches(loss, got, want_loss, want, start, head):
    """One SGD step of the port against the JAX package's, at the tolerances
    of tests/test_torch_train.py: the loss to 5e-4 relative; parameters
    rtol 5e-3 / atol 5e-4, running means atol 0.03, variances rtol and atol
    0.05; then sharper, since one update at lr 1e-3 is smaller than those:
    the running statistics to 1e-3 / 1e-4, the class conv's update (`head`)
    to 1% of its largest entry, all updates jointly to 10% in norm."""
    np.testing.assert_allclose(loss, want_loss, rtol=5e-4)
    assert set(got) == set(want)
    num = den = 0.0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
        elif "running_" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=5e-4,
                                       err_msg=k)
            moved, want_moved = got[k] - start[k].numpy(), w - start[k].numpy()
            num += float(((moved - want_moved) ** 2).sum())
            den += float((want_moved ** 2).sum())
            if k.startswith(head):
                assert (np.abs(moved - want_moved).max()
                        <= 0.01 * np.abs(want_moved).max()), k
    assert den > 0 and np.sqrt(num / den) <= 0.1, np.sqrt(num / den)
