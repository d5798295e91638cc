"""PyTorch port: the train CLI's losses and extras (ops/loss.py's
weighted CE, Dice, focal BCE, Lovász-softmax and `build_loss`,
ops/rect_loss.py, data/mix.py, `PostFetch(mix_fn=)`, `distill_loss` and the
distillation train step, the train CLI's flags) against the JAX package on
the same seeded numpy inputs, on the CPU.

Each group's JAX references are one compiled program, computed once per
module (`_jax_refs`); the cases then compare. Tolerances: f32 losses to
LOSS_RTOL (means of ~3e3 terms: XLA's CPU reduction adds in order, whose
rounding grows as n * eps / 2, and its exp and log differ from torch's by
an ulp or two), their gradients to GRAD_RTOL / GRAD_ATOL (elementwise, of
order 1/N = 1.5e-4 and above); `rect_targets`, the mixes and the PostFetch
outputs exactly."""

import functools
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_segmentation_tpu.data import mix as jmix
from pytorch_segmentation_tpu.engine import steps as jsteps
from pytorch_segmentation_tpu.ops import loss as jloss
from pytorch_segmentation_tpu.ops.rect_loss import rect_loss as jrect_loss
from pytorch_segmentation_tpu.ops.rect_loss import (
    rect_targets as jrect_targets)
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.data import augment as taug
from pytorch_segmentation_tpu_torch.data import mix as tmix
from pytorch_segmentation_tpu_torch.data.loader import Batch
from pytorch_segmentation_tpu_torch.data.pipeline import (PostFetch,
                                                          normalize_images)
from pytorch_segmentation_tpu_torch.engine import steps as tsteps
from pytorch_segmentation_tpu_torch.engine import trainer as ttrainer
from pytorch_segmentation_tpu_torch.models import DeepLabV3Plus, build_model
from pytorch_segmentation_tpu_torch.ops import loss as tloss
from pytorch_segmentation_tpu_torch.ops.rect_loss import (rect_loss,
                                                         rect_targets)
from pytorch_segmentation_tpu_torch.utils.synthetic import make_synthetic_coco
from pytorch_segmentation_tpu_torch.utils.weights import (seeded_state_dict,
                                                          state_dict_from_jax)
from test_torch_train import _JaxTiny, _TorchTiny
from torch_family_util import FAST_COMPILE

torch.set_num_threads(1)

NC = 5
SHAPE = (2, 17, 19, NC)
LOW = (2, 5, 6, NC)          # low-resolution logits for build_loss
IGNORE = 255
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-8
CW = np.array([0.5, 1.0, 2.0, 1.5, 0.25], np.float32)


def _compiled(fn, *args):
    """fn(*args) through one XLA program compiled without LLVM's expensive
    passes (torch_family_util.FAST_COMPILE)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _inputs(kind):
    """(logits f32 SHAPE, labels int32 SHAPE[:3]) made from a seed.
    'random': normal logits, every class, some IGNORE pixels; 'tied':
    logits 0 or -200 (at least one 0 a pixel), so every probability is 0 or
    1/k, k = 1..5, the same in both packages, and Lovász errors tie in long
    runs; labels from {0, 1, 3} (classes 2 and 4 absent)."""
    rng = np.random.default_rng({"random": 0, "tied": 1}[kind])
    if kind == "tied":
        top = rng.random(SHAPE) < 0.4
        top[..., 0] |= ~top.any(-1)
        x = np.where(top, 0.0, -200.0).astype(np.float32)
        y = rng.choice(np.array([0, 1, 3], np.int32), SHAPE[:3])
        return x, y
    x = (1.5 * rng.standard_normal(SHAPE)).astype(np.float32)
    y = rng.integers(0, NC, SHAPE[:3]).astype(np.int32)
    y[rng.random(SHAPE[:3]) < 0.1] = IGNORE
    return x, y


def _in_range(y):
    """The labels with IGNORE pixels set to class 0."""
    return np.where(y == IGNORE, 0, y).astype(np.int32)


def _torch_value_and_grad(fn, x, *args):
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    value = fn(xt, *args)
    (grad,) = torch.autograd.grad(value, [xt])
    return float(value.detach()), grad.numpy()


def _assert_value_and_grad(got, want, what):
    np.testing.assert_allclose(got[0], float(want[0]), rtol=LOSS_RTOL,
                               err_msg=f"{what}: loss")
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL, err_msg=f"{what}: gradient")


# ------------------------------------------------- weighted cross-entropy

# (knobs, labels with IGNORE pixels); ohem_thresh 0.05 makes the k-th
# smallest true-class probability the cutoff, 0.7 the threshold
WCE_KNOBS = {
    "weights": dict(class_weights=CW),
    "smoothing": dict(label_smoothing=0.1),
    "weights_smoothing": dict(class_weights=CW, label_smoothing=0.2),
    "ohem_kth": dict(ohem_frac=0.25, ohem_thresh=0.05),
    "ohem_thresh": dict(ohem_frac=0.1, ohem_thresh=0.7),
    "ignore": dict(ignore_index=IGNORE),
    "all": dict(class_weights=CW, label_smoothing=0.1, ohem_frac=0.3,
                ohem_thresh=0.05, ignore_index=IGNORE),
}


def _wce_labels(name, y):
    return y if "ignore_index" in WCE_KNOBS[name] else _in_range(y)


@functools.cache
def _jax_refs(group):
    """The JAX package's results of one group, one compiled program each."""
    if group == "wce":
        x, y = _inputs("random")

        def run(x, labels):
            return {name: jax.value_and_grad(
                lambda l: jloss.weighted_cross_entropy(l, labels[name],
                                                       **kw))(x)
                for name, kw in WCE_KNOBS.items()}
        return _compiled(run, x, {name: _wce_labels(name, y)
                                  for name in WCE_KNOBS})
    if group == "others":
        out = {}
        for kind in ("random", "tied"):
            x, y = _inputs(kind)
            y = _in_range(y)

            def run(x, y):
                return {
                    "lovasz_grad": jloss._lovasz_grad(
                        (y.reshape(-1) == 1).astype(jnp.float32)),
                    "dice": jax.value_and_grad(jloss.dice_loss)(x, y),
                    "lovasz": jax.value_and_grad(
                        jloss.lovasz_softmax_loss)(x, y),
                    "focal": jax.value_and_grad(
                        lambda l: jloss.focal_bce_loss(
                            l, jax.nn.one_hot(y, NC)))(x)}
            out.update({(name, kind): v
                        for name, v in _compiled(run, x, y).items()})
        return out
    if group == "rect":
        out = {}
        for kind in ("blocky", "random"):
            x = _rect_logits(kind)

            def run(x):
                return {"targets": jrect_targets(jnp.argmax(x, -1), NC),
                        "mean": jax.value_and_grad(jrect_loss)(x),
                        "sum": jrect_loss(x, reduction="sum"),
                        "none": jrect_loss(x, weight=0.5, reduction="none")}
            out[kind] = _compiled(run, x)
        return out
    if group == "build":
        x, y = _build_inputs()

        def run(x, y):
            return {case: jloss.build_loss(name, align_corners=align,
                                           **kw)(x, y)
                    for case, (name, align, kw) in BUILD_CASES.items()}
        return _compiled(run, x, y)
    if group == "distill":
        rng = np.random.default_rng(5)
        s = rng.standard_normal(LOW).astype(np.float32)
        teachers = {"same_grid": rng.standard_normal(LOW),
                    "other_grid": rng.standard_normal((2, 9, 11, NC))}

        def run(s, ts):
            return {k: jax.value_and_grad(jsteps.distill_loss)(s, t, 3.0)
                    for k, t in ts.items()}
        return s, teachers, _compiled(
            run, s, {k: t.astype(np.float32) for k, t in teachers.items()})
    if group == "mix":
        images, segs = _mix_batch()

        def run(key, images, segs):
            k_m, k_c = jax.random.split(key)
            both = jmix.make_mix_fn(cutmix_p=0.7, mosaic_p=0.5)
            return {
                "cutmix": (_jax_cutmix_draws(key, 0.6),
                           jmix.cutmix(key, images, segs, 0.6)),
                "mosaic": (_jax_mosaic_draws(key, 0.6),
                           jmix.mosaic(key, images, segs, 0.6)),
                "make_mix_fn": ({"mosaic": _jax_mosaic_draws(k_m, 0.5),
                                 "cutmix": _jax_cutmix_draws(k_c, 0.7)},
                                both(key, images, segs))}
        return _compiled(run, jax.random.PRNGKey(7), images, segs)
    raise KeyError(group)


@pytest.mark.parametrize("name", list(WCE_KNOBS))
def test_weighted_cross_entropy_matches_jax(name):
    x, y = _inputs("random")
    got = _torch_value_and_grad(
        lambda l: tloss.weighted_cross_entropy(
            l, torch.from_numpy(_wce_labels(name, y)), **WCE_KNOBS[name]), x)
    _assert_value_and_grad(got, _jax_refs("wce")[name], name)


# ------------------------------------------------- Dice, focal, Lovász

OTHER_LOSSES = {
    "dice": tloss.dice_loss, "lovasz": tloss.lovasz_softmax_loss,
    "focal": lambda l, t: tloss.focal_bce_loss(
        l, torch.nn.functional.one_hot(t.long(), NC))}


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("name", list(OTHER_LOSSES))
def test_dice_focal_lovasz_match_jax(name, kind):
    """Values and gradients; 'tied' has absent classes and runs of exactly
    equal Lovász errors, whose gradient follows the sort's tie order."""
    x, y = _inputs(kind)
    y = _in_range(y)
    if kind == "tied":
        errors = np.abs((y[..., None] == np.arange(NC))
                        - torch.softmax(torch.from_numpy(x), -1).numpy())
        assert len(np.unique(errors)) <= 10
        assert set(np.unique(y)) == {0, 1, 3}
    got = _torch_value_and_grad(OTHER_LOSSES[name], x, torch.from_numpy(y))
    _assert_value_and_grad(got, _jax_refs("others")[(name, kind)],
                           f"{name} {kind}")


def test_lovasz_grad_and_absent_classes():
    """`_lovasz_grad` equals the JAX function's bits on a 0/1 vector (its
    cumulative sums are integers), and a batch holding one class: the other
    classes add nothing."""
    _, y = _inputs("random")
    gt = (_in_range(y).reshape(-1) == 1).astype(np.float32)
    np.testing.assert_array_equal(
        tloss._lovasz_grad(torch.from_numpy(gt)).numpy(),
        np.asarray(_jax_refs("others")[("lovasz_grad", "random")]))
    x = torch.zeros((1, 2, 2, 3))
    one_class = tloss.lovasz_softmax_loss(x, torch.ones((1, 2, 2)).long())
    # every pixel class 1 at p = 1/3: errors 2/3, Jaccard loss 2/3
    assert abs(float(one_class) - 2.0 / 3.0) < 1e-6


# ------------------------------------------------- rect loss

def _rect_logits(kind):
    """'blocky': 5x5-pixel blocks of one winning class (class 4 never
    wins), so each class's mask is a union of blocks; 'random': noise."""
    rng = np.random.default_rng({"blocky": 2, "random": 3}[kind])
    if kind == "random":
        return rng.standard_normal(SHAPE).astype(np.float32)
    small = rng.standard_normal((2, 4, 4, NC)).astype(np.float32)
    small[..., 4] -= 10.0
    x = np.repeat(np.repeat(small, 5, 1), 5, 2)[:, :SHAPE[1], :SHAPE[2]]
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ["blocky", "random"])
def test_rect_targets_and_loss_match_jax(kind):
    x = _rect_logits(kind)
    want = _jax_refs("rect")[kind]
    pred = torch.from_numpy(x).argmax(-1)
    targets = rect_targets(pred, NC).numpy()
    np.testing.assert_array_equal(targets, np.asarray(want["targets"]))
    if kind == "blocky":
        assert not targets[..., 4].any()              # absent: no rectangle
        assert 0 < targets[..., :4].mean() < 1
    got = _torch_value_and_grad(rect_loss, x)
    _assert_value_and_grad(got, want["mean"], f"rect {kind} mean")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(float(rect_loss(xt, reduction="sum")),
                               float(want["sum"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        rect_loss(xt, weight=0.5, reduction="none").numpy(),
        np.asarray(want["none"]), rtol=1e-6, atol=1e-7)


# ------------------------------------------------- build_loss

KNOBS = dict(class_weights=CW, label_smoothing=0.1, ohem_frac=0.3,
             ohem_thresh=0.05, ignore_index=IGNORE)
BUILD_CASES = {f"{name}-{'align' if align else 'half'}": (name, align, {})
               for name in jloss.LOSSES for align in (True, False)}
BUILD_CASES.update({f"{name}-knobs": (name, False, KNOBS)
                    for name in ("ce", "ce+lovasz", "ce+rect", "ce+dice")})


def _build_inputs():
    """Low-resolution logits and labels at SHAPE's resolution. The labels
    keep their IGNORE pixels in every case: without `ignore_index` both
    packages clip a label into [0, C)."""
    rng = np.random.default_rng(4)
    x = (2.0 * rng.standard_normal(LOW)).astype(np.float32)
    _, y = _inputs("random")
    return x, y


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_loss_matches_jax(case):
    name, align, kw = BUILD_CASES[case]
    x, y = _build_inputs()
    fn = tloss.build_loss(name, align_corners=align, **kw)
    got = float(fn(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, float(_jax_refs("build")[case]),
                               rtol=LOSS_RTOL, err_msg=case)


def test_build_loss_ce_is_compute_loss_and_knobs_need_a_ce_term():
    """Plain 'ce' is `compute_loss` itself (the Trainer's test for the
    deferred upsample); a knob on a loss without a CE term and an unknown
    name raise the JAX package's ValueErrors."""
    assert tloss.build_loss("ce") is tloss.compute_loss
    assert tloss.build_loss("ce", align_corners=False) is tloss.compute_loss
    assert tloss.build_loss("ce", label_smoothing=0.1) is not \
        tloss.compute_loss
    assert tloss.LOSSES == jloss.LOSSES
    for name in ("lovasz", "focal", "dice"):
        for kw in ({"class_weights": CW}, {"label_smoothing": 0.1},
                   {"ohem_frac": 0.2}, {"ignore_index": 0}):
            with pytest.raises(ValueError, match=f"loss '{name}' has none"):
                tloss.build_loss(name, **kw)
            with pytest.raises(ValueError, match=f"loss '{name}' has none"):
                jloss.build_loss(name, **kw)
    with pytest.raises(ValueError, match="unknown loss 'l2'"):
        tloss.build_loss("l2")


# ------------------------------------------------- CutMix and Mosaic

MIX_B, MIX_HW = 6, (16, 20)


def _mix_batch(hw=MIX_HW):
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (MIX_B, *hw, 3)).astype(np.uint8)
    segs = rng.integers(0, NC, (MIX_B, *hw)).astype(np.uint8)
    return images, segs


def _jax_cutmix_draws(key, p):
    """The values JAX's cutmix draws inside, from the same split keys."""
    k_gate, k_lam, k_cy, k_cx = jax.random.split(key, 4)
    return {"gate": jax.random.bernoulli(k_gate, p, (MIX_B,)),
            "lam": jax.random.uniform(k_lam, (MIX_B,)),
            "cy": jax.random.uniform(k_cy, (MIX_B,)),
            "cx": jax.random.uniform(k_cx, (MIX_B,))}


def _jax_mosaic_draws(key, p):
    k_gate, k_cy, k_cx = jax.random.split(key, 3)
    return {"gate": jax.random.bernoulli(k_gate, p, (MIX_B,)),
            "cy": jax.random.uniform(k_cy, (MIX_B, 1, 1), minval=0.25,
                                     maxval=0.75).reshape(MIX_B),
            "cx": jax.random.uniform(k_cx, (MIX_B, 1, 1), minval=0.25,
                                     maxval=0.75).reshape(MIX_B)}


def _as_torch(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("which", ["cutmix", "mosaic", "make_mix_fn"])
def test_mix_matches_jax_under_its_draws(which):
    """The port's apply half on the values JAX draws equals the JAX mix bit
    for bit, images and labels; some samples are gated in, some out."""
    images, segs = _mix_batch()
    draws, want = _jax_refs("mix")[which]
    args = (torch.from_numpy(images), torch.from_numpy(segs))
    if which == "cutmix":
        got = tmix.apply_cutmix(_as_torch(draws), *args)
        gates = [draws["gate"]]
    elif which == "mosaic":
        got = tmix.apply_mosaic(_as_torch(draws), *args)
        gates = [draws["gate"]]
    else:
        fn = tmix.make_mix_fn(cutmix_p=0.7, mosaic_p=0.5)
        got = fn.apply({k: _as_torch(v) for k, v in draws.items()}, *args)
        gates = [d["gate"] for d in draws.values()]
    for gate in gates:
        assert np.asarray(gate).any() and not np.asarray(gate).all()
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.array_equal(got[0].numpy(), images)


def test_make_mix_fn_draws_and_gates():
    """make_mix_fn(0, 0) is None in both packages; the port's draw half
    gives the apply half what it reads, mosaic first; p=1 mixes every
    sample and p=0 none."""
    assert tmix.make_mix_fn(0.0, 0.0) is None
    assert jmix.make_mix_fn(0.0, 0.0) is None
    gen = torch.Generator().manual_seed(0)
    both = tmix.make_mix_fn(cutmix_p=1.0, mosaic_p=1.0).draw(gen, 4)
    assert list(both) == ["mosaic", "cutmix"]
    assert both["cutmix"]["gate"].all() and both["mosaic"]["gate"].all()
    assert ((both["mosaic"]["cy"] >= 0.25) & (both["mosaic"]["cy"] < 0.75)
            ).all()
    assert list(tmix.make_mix_fn(cutmix_p=0.5).draw(gen, 4)) == ["cutmix"]
    images, segs = _mix_batch()
    images, segs = torch.from_numpy(images), torch.from_numpy(segs)
    same = tmix.cutmix(gen, images, segs, 0.0)
    assert torch.equal(same[0], images) and torch.equal(same[1], segs)
    assert not torch.equal(tmix.mosaic(gen, images, segs, 1.0)[1], segs)


# ------------------------------------------------- PostFetch(mix_fn=)

def test_postfetch_mixes_before_the_augmentation_on_its_own_stream():
    """PostFetch(aug, mix_fn=mix) at batch k equals the augmentation, with
    the generators PostFetch(aug) uses at batch k, applied to the mix's
    output from `mix_generator(k)`: the mix comes first and does not move
    the augmentation's draws. Without an augment_fn the mixed batch is
    normalized as it is."""
    images, segs = _mix_batch((16, 16))
    batch = Batch(images, segs, MIX_B)
    aug = taug.make_augment_fn()
    mix = tmix.make_mix_fn(cutmix_p=0.5, mosaic_p=0.5)
    post = PostFetch(aug, seed=3, mix_fn=mix, device="cpu")
    plain = PostFetch(aug, seed=3, device="cpu")
    for step in range(2):
        got = post(batch)
        mixed = mix(post.mix_generator(step), torch.from_numpy(images),
                    torch.from_numpy(segs))
        assert not torch.equal(mixed[1], torch.from_numpy(segs))
        gen, host_gen = plain.generators(step)
        want = aug(gen, *mixed, host_gen=host_gen)
        assert torch.equal(got[0], normalize_images(want[0]))
        assert torch.equal(got[1], want[1].to(torch.int32))
        assert got[2] == MIX_B
    seeds = {g.initial_seed() for step in range(50)
             for g in (*post.generators(step), post.mix_generator(step))}
    assert len(seeds) == 150
    alone = PostFetch(seed=3, mix_fn=mix, device="cpu")(batch)
    mixed = mix(post.mix_generator(0), torch.from_numpy(images),
                torch.from_numpy(segs))
    assert torch.equal(alone[0], normalize_images(mixed[0]))
    assert torch.equal(alone[1], mixed[1].to(torch.int32))


# ------------------------------------------------- distillation

@pytest.mark.parametrize("grid", ["same_grid", "other_grid"])
def test_distill_loss_matches_jax(grid):
    s, teachers, want = _jax_refs("distill")
    t = torch.from_numpy(teachers[grid].astype(np.float32))
    got = _torch_value_and_grad(
        lambda x: tsteps.distill_loss(x, t, 3.0), s)
    _assert_value_and_grad(got, want[grid], grid)


def test_distillation_train_step_matches_jax():
    """Two steps of make_train_step(distill_fn=, distill_weight=0.5,
    distill_temp=3) on the tiny ConvNormAct model with another seed's tiny
    model as the frozen teacher: the losses and the parameters equal the
    JAX step's (its two steps and the inits in one compiled program), the
    first loss is the plain step's plus 0.5 * distill_loss, and the teacher
    does not move."""
    module = _JaxTiny()
    tx = optax.sgd(0.1, momentum=0.9)
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    ys = rng.integers(0, 3, (2, 2, 16, 16)).astype(np.int32)

    def run(xs, ys):
        student, teacher = (module.init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 16, 16, 3)))
                            for seed in (0, 1))
        state = jsteps.TrainState(
            step=jnp.zeros((), jnp.int32), params=student["params"],
            batch_stats=student["batch_stats"],
            opt_state=tx.init(student["params"]), tx=tx,
            apply_fn=module.apply, micro_step=jnp.zeros((), jnp.int32))
        step = jsteps.make_train_step(
            distill_fn=lambda x: module.apply(teacher, x, train=False),
            distill_weight=0.5, distill_temp=3.0, donate=False)
        losses = []
        for x, y in zip(xs, ys):
            state, loss = step(state, x, y)
            losses.append(loss)
        return student, teacher, losses, state.params, state.batch_stats
    student, teacher, jlosses, params, stats = jax.tree.map(
        np.asarray, _compiled(run, xs, ys))

    def torch_model(variables):
        model = _TorchTiny()
        model.load_state_dict({
            k: torch.from_numpy(v.copy()) for k, v in state_dict_from_jax(
                variables["params"], variables["batch_stats"]).items()})
        return model
    tmodel, tteacher = torch_model(student), torch_model(teacher).eval()
    teacher_before = {k: v.clone() for k, v in tteacher.state_dict().items()}
    distill_fn = tsteps.nhwc_forward(tteacher)
    tstate = tsteps.create_train_state(tmodel, ttrainer.make_optimizer(
        tmodel.parameters(), lr=0.1, momentum=0.9))
    tstep = tsteps.make_train_step(distill_fn=distill_fn, distill_weight=0.5,
                                   distill_temp=3.0)
    # the plain step and the distillation term on the first batch
    plain_model = torch_model(student)
    x0 = torch.from_numpy(xs[0])
    with torch.no_grad():
        term = tsteps.distill_loss(
            plain_model.train()(x0.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
            distill_fn(x0), 3.0)
    _, plain = tsteps.make_train_step()(tsteps.create_train_state(
        plain_model, ttrainer.make_optimizer(plain_model.parameters())),
        x0, torch.from_numpy(ys[0]))
    for x, y, jl in zip(xs, ys, jlosses):
        tstate, tl = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        if plain is not None:
            np.testing.assert_allclose(float(tl), float(plain + 0.5 * term),
                                       rtol=1e-6)
            assert float(term) > 1e-3
            plain = None
    want = state_dict_from_jax(params, stats)
    for k, v in tmodel.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    for k, v in tteacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k


def test_distillation_needs_per_pixel_logits_and_a_weight():
    """A dict-returning model (MaskFormer's) refuses the distillation term;
    distill_weight=0 leaves the step as it is."""
    class Dict(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = _TorchTiny()

        def forward(self, x):
            return {"cls": self.inner(x)}
    model = Dict()
    state = tsteps.create_train_state(model, ttrainer.make_optimizer(
        model.parameters()))
    images = torch.zeros((1, 8, 8, 3))
    segs = torch.zeros((1, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="per-pixel logits"):
        tsteps.make_train_step(loss_fn=lambda o, s: o["cls"].sum(),
                               distill_fn=lambda x: x, distill_weight=1.0)(
            state, images, segs)
    calls = []
    tsteps.make_train_step(loss_fn=lambda o, s: o["cls"].sum(),
                           distill_fn=calls.append, distill_weight=0.0)(
        state, images, segs)
    assert calls == []


# ------------------------------------------------- the train CLI

def test_parse_class_weights_matches_the_root_cli(tmp_path):
    import train as root_train
    (tmp_path / "list.json").write_text(json.dumps([1, 2.5, 0]))
    (tmp_path / "dict.json").write_text(json.dumps({"weights": [3, 4, 5]}))
    for spec in ("", "0.5,1,2", str(tmp_path / "list.json"),
                 str(tmp_path / "dict.json")):
        assert (ttrain.parse_class_weights(spec, 3)
                == root_train.parse_class_weights(spec, 3))
    assert ttrain.parse_class_weights("0.5,1,2", 3) == [0.5, 1.0, 2.0]
    for parse in (ttrain.parse_class_weights,
                  root_train.parse_class_weights):
        with pytest.raises(SystemExit, match="has 2 entries, dataset has "
                                             "3 classes"):
            parse("1,2", 3)


def test_train_cli_runs_every_loss_mix_and_distill_flag(tmp_path,
                                                        monkeypatch):
    """One CPU epoch of `train` with every item-7 flag: `--loss ce+dice`
    with class weights from a file, label smoothing, OHEM and ignore_index
    on its CE term, CutMix and Mosaic, and distillation from a seeded
    SegFormer teacher's `.pt` (another family, its `--distill-variant`).
    The shallow DeepLabV3+ student stands in for the full one."""
    built = []

    def build(name, num_classes, **kwargs):
        built.append((name, kwargs.get("full_res_output")))
        if name == "deeplabv3plus":
            return DeepLabV3Plus(num_classes=num_classes,
                                 backbone_layers=(1, 1, 1, 1), **kwargs)
        return build_model(name, num_classes, **kwargs)
    monkeypatch.setattr(ttrain, "build_model", build)
    monkeypatch.chdir(tmp_path)
    make_synthetic_coco("coco", num_train=4, num_val=2, img_size=(80, 60),
                        seed=1, num_classes=3)
    teacher = build_model("segformer", 4, variant="tiny")
    torch.save({"model": seeded_state_dict(teacher, 2)}, "teacher.pt")
    (tmp_path / "w.json").write_text(json.dumps({"weights": [1, 2, 2, 1]}))
    seen = {}
    real_build_loss = ttrain.build_loss

    def spy(*args, **kwargs):
        seen.update(kwargs, name=args[0])
        return real_build_loss(*args, **kwargs)
    monkeypatch.setattr(ttrain, "build_loss", spy)
    trainer = ttrain.main(
        ["coco", "--model", "deeplabv3plus", "--dataset", "coco", "-s", "64",
         "64", "-bs", "2", "-a", "1", "--num-workers", "1", "--epochs", "1",
         "--notest", "--loss", "ce+dice", "--class-weights", "w.json",
         "--label-smoothing", "0.1", "--ohem", "0.5", "--ohem-thresh",
         "0.6", "--ignore-index", "255", "--cutmix", "0.5", "--mosaic",
         "0.5", "--distill", "teacher.pt", "--distill-model", "segformer",
         "--distill-variant", "tiny", "--distill-weight", "0.5",
         "--distill-temp", "3"], device="cpu")
    assert trainer.epoch == 1 and trainer.state.step == 2
    assert built == [("deeplabv3plus", None), ("segformer", False)]
    assert seen == dict(name="ce+dice", align_corners=True,
                        class_weights=[1.0, 2.0, 2.0, 1.0],
                        label_smoothing=0.1, ohem_frac=0.5, ohem_thresh=0.6,
                        ignore_index=255)
    post = trainer.fetcher.post_fetch_fn
    assert (post.mix_fn.cutmix_p, post.mix_fn.mosaic_p) == (0.5, 0.5)
    with open("runs/log.jsonl") as f:
        assert np.isfinite(json.loads(f.readline())["loss"])
    assert osp.exists("weights/last.pt")
    with pytest.raises(SystemExit, match="--loss is fixed"):
        ttrain.train("coco", "maskformer", 1, (64, 64), 2, 1, 1e-3, False,
                     False, "", 1, False, False, False, True, True,
                     dataset="coco", loss="dice", device="cpu")
