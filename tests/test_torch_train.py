"""PyTorch port: the train slice (train-mode BatchNorm, LR schedules, the
optimizer chain, the train step and the Trainer) against the JAX package on
the same seeded weights and numpy batches, on the CPU. Sizes are cut for the
test budget: ResNet layers (1,1,1,1), 3 classes, 2x64x64 batches, f32."""

import functools
import json
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_segmentation_tpu.engine import steps as jsteps
from pytorch_segmentation_tpu.engine import trainer as jtrainer
from pytorch_segmentation_tpu.models import DeepLabV3Plus as JaxDeepLabV3Plus
from pytorch_segmentation_tpu.nn import blocks as jblocks
from pytorch_segmentation_tpu.ops.loss import compute_loss as jax_compute_loss
from pytorch_segmentation_tpu_torch.engine import steps as tsteps
from pytorch_segmentation_tpu_torch.engine import trainer as ttrainer
from pytorch_segmentation_tpu_torch.engine.checkpoint import load_model_bundle
from pytorch_segmentation_tpu_torch.inference import (make_mask_fn,
                                                       make_tiled_mask_fn)
from pytorch_segmentation_tpu_torch.models import build_model
from pytorch_segmentation_tpu_torch.nn import blocks as tblocks
from pytorch_segmentation_tpu_torch.ops.loss import compute_loss
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, load_state, seeded_state_dict,
    state_dict_from_jax)

torch.set_num_threads(1)

# the benchmarked train step's optimizer: SGD 1e-3, momentum 0.9
LR, MOMENTUM, N_STEPS = 1e-3, 0.9, 6
NC, BS, HW = 3, 2, 64
LAYERS = (1, 1, 1, 1)


# ---------------------------------------------------------------- BatchNorm

def _bn_pair(dtype, c, rng):
    """The JAX module's variables and the port's module on the same values."""
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jbn = jblocks.BatchNorm2d(dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    tbn = tblocks.BatchNorm2d(c, dtype=dtype)
    tbn.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean),
        "running_var": torch.from_numpy(var),
        "num_batches_tracked": torch.zeros((), dtype=torch.int64)})
    return jbn, variables, tbn.train()


def _bn_both(dtype, seed=0):
    """Two train-mode calls on both sides; returns per side (output of the
    first call, gradients of sum(y * r) w.r.t. input, scale and bias, and
    the running statistics after the second call), as f32 numpy, NHWC."""
    rng = np.random.default_rng(seed)
    c = 6
    jbn, variables, tbn = _bn_pair(dtype, c, rng)
    xs = [(2.0 * rng.standard_normal((3, 5, 7, c)) + 0.5).astype(np.float32)
          for _ in range(2)]
    r = rng.standard_normal((3, 5, 7, c)).astype(np.float32)
    jdt = jbn.dtype

    def jax_loss(params, x, stats):
        y, mut = jbn.apply({"params": params, "batch_stats": stats}, x,
                           use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * r), (y, mut["batch_stats"])

    jx = jnp.asarray(xs[0], jdt)
    (_, (jy, stats1)), (jgp, jgx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
            variables["params"], jx, variables["batch_stats"])
    _, (_, stats2) = jax_loss(variables["params"], jnp.asarray(xs[1], jdt),
                              stats1)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    want = dict(y=f32(jy), gx=f32(jgx), gw=f32(jgp["scale"]),
                gb=f32(jgp["bias"]), mean=f32(stats2["mean"]),
                var=f32(stats2["var"]))

    exact = torch.from_numpy(f32(jx).copy())  # the values the JAX side saw
    tx = exact.to(dtype).permute(0, 3, 1, 2).requires_grad_(True)
    ty = tbn(tx)
    assert ty.dtype == dtype
    (ty.float() * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    tbn(torch.from_numpy(xs[1]).to(dtype).permute(0, 3, 1, 2))
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()
    got = dict(y=nhwc(ty), gx=nhwc(tx.grad), gw=tbn.weight.grad.numpy(),
               gb=tbn.bias.grad.numpy(), mean=tbn.running_mean.numpy(),
               var=tbn.running_var.numpy())
    assert int(tbn.num_batches_tracked) == 2
    assert not tbn.running_mean.requires_grad
    return got, want


def test_train_batchnorm_matches_jax_f32():
    got, want = _bn_both(torch.float32)
    for k in ("y", "gx", "gw", "gb"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    # running statistics after two calls: momentum 0.1, unbiased variance
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_train_batchnorm_matches_jax_bf16():
    """bf16 compute, f32 parameters and statistics. The two sides round at
    the same places, so the output differs at most where a summation order
    tips a rounding: two bf16 ulps of the largest value anywhere, and on
    average at most 40% of what bf16 differs from f32 (measured: the outputs
    are equal; scale and shift applied in f32 instead, a moved cast, gives
    70-75%). The input gradient adds the path through the statistics, whose
    per-channel cotangents are bf16 reductions summed in another order on
    the two sides: measured 39-56% of the bf16 error over three seeds
    against 78-85% with the moved cast; the bound is 65%."""
    got, want = _bn_both(torch.bfloat16)
    _, f32 = _bn_both(torch.float32)
    for k, share in (("y", 0.4), ("gx", 0.65)):
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 ** -7 * np.abs(want[k]).max(), (k, diff.max())
        bf16_error = np.abs(want[k] - f32[k]).mean()
        assert diff.mean() <= share * bf16_error, (k, diff.mean(), bf16_error)
    # per-channel gradient sums are reductions of 105 bf16 products, rounded
    # to bf16, accumulated in another order and precision on the two sides:
    # four bf16 ulps of the largest entry
    for k in ("gw", "gb"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2 ** -5 * np.abs(want[k]).max())
    for k in ("mean", "var"):  # f32 statistics of the same bf16 values
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_batchnorm_on_a_1x1_map_and_eval_after_train():
    """The ASPP pool branch normalizes a 1x1 map over batch 2; nothing
    caches an eval-mode fold across a train step."""
    rng = np.random.default_rng(1)
    jbn, variables, tbn = _bn_pair(torch.float32, 4, rng)
    x = rng.standard_normal((2, 1, 1, 4)).astype(np.float32)
    jy, mut = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                        mutable=["batch_stats"])
    ty = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=0, atol=1e-5)
    want = jbn.apply({"params": variables["params"],
                      "batch_stats": mut["batch_stats"]}, jnp.asarray(x),
                     use_running_average=True)
    got = tbn.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


# ------------------------------------------------- schedules and optimizers

@pytest.mark.parametrize("name,warmup,total", [
    ("constant", 0, None), ("constant", 5, None), ("cosine", 0, 40),
    ("cosine", 5, 40), ("poly", 0, 40), ("poly", 5, None)])
def test_lr_schedule_matches_optax(name, warmup, total):
    want = jtrainer.make_lr_schedule(name, 0.1, warmup, total)
    got = ttrainer.make_lr_schedule(name, 0.1, warmup, total)
    counts = list(range(12)) + [15, 20, 30, 38, 39, 40, 41, 100]
    assert len(counts) == 20
    for count in counts:
        w = float(want(count)) if callable(want) else want
        np.testing.assert_allclose(got(count), w, rtol=2e-6, atol=1e-9,
                                   err_msg=f"count {count}")
    with pytest.raises(ValueError, match="unknown lr schedule"):
        ttrainer.make_lr_schedule("step", 0.1)


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
def test_optimizer_chain_matches_optax(adam):
    """clip the raw gradients' norm -> coupled weight decay -> SGD with
    momentum (or Adam) under a schedule, 5 updates on a toy tree. The JAX
    side is built as engine/trainer.py builds its chain."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    values = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    # large and small gradients: the clip triggers on some updates only
    grads = [{k: (sc * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()}
             for sc in (1.0, 0.01, 2.0, 0.02, 0.5)]
    kw = dict(lr_schedule="poly", warmup_steps=2, total_steps=8)
    schedule = jtrainer.make_lr_schedule(kw["lr_schedule"], 0.05,
                                         kw["warmup_steps"], kw["total_steps"])
    tx = optax.adam(schedule) if adam else optax.sgd(schedule, momentum=0.9,
                                                     nesterov=False)
    tx = optax.chain(optax.add_decayed_weights(1e-2), tx)
    tx = optax.chain(optax.clip_by_global_norm(1.0), tx)
    jparams = {k: jnp.asarray(v) for k, v in values.items()}
    opt_state = tx.init(jparams)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in values.items()}
    chain = ttrainer.make_optimizer(tparams.values(), lr=0.05, adam=adam,
                                    momentum=0.9, weight_decay=1e-2,
                                    clip_grad=1.0, **kw)
    for count, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        chain.apply(count)
        for k in shapes:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]),
                rtol=1e-5, atol=1e-6, err_msg=f"{k} after update {count}")


# ------------------------------------------------------------ the train step

class _JaxTiny(fnn.Module):
    """ConvNormAct(8) + 1x1 class conv: enough for the step's bookkeeping."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = jblocks.ConvNormAct(8, dtype=jnp.float32, name="block")(
            x, train=train)
        return fnn.Conv(NC, (1, 1), name="cls_conv")(x)


class _TorchTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.block = tblocks.ConvNormAct(3, 8, dtype=torch.float32)
        self.cls_conv = torch.nn.Conv2d(8, NC, 1)

    def forward(self, x):
        return self.cls_conv(self.block(x))


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jax_state(module, variables, tx, accumulate=1, ema=False):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx, apply_fn=module.apply,
        grad_acc=(jax.tree.map(jnp.zeros_like, params) if accumulate > 1
                  else None),
        micro_step=jnp.zeros((), jnp.int32),
        ema_params=(jax.tree.map(lambda p: jnp.array(p, copy=True), params)
                    if ema else None))


def _batches(n, seed, hw=HW):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BS, hw, hw, 3)).astype(np.float32),
             rng.integers(0, NC, (BS, hw, hw)).astype(np.int32))
            for _ in range(n)]


def _assert_state_dicts_close(got, want, rtol, atol):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=rtol,
                                   atol=atol, err_msg=k)


def test_accumulate_and_ema_match_jax():
    """accumulate=2 with ema_decay=0.9: 4 calls are 2 optimizer updates; the
    parameters, BN statistics, EMA weights and counters equal the JAX
    state's after every call."""
    module = _JaxTiny()
    variables = _numpy_tree(module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False))
    tx = optax.sgd(0.1, momentum=MOMENTUM)
    jstate = _jax_state(module, variables, tx, accumulate=2, ema=True)
    jstep = jsteps.make_train_step(accumulate=2, donate=False, ema_decay=0.9)

    tmodel = _TorchTiny()
    tmodel.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                            state_dict_from_jax(variables["params"],
                                                variables["batch_stats"]
                                                ).items()})
    tstate = tsteps.create_train_state(
        tmodel, ttrainer.make_optimizer(tmodel.parameters(), lr=0.1,
                                        momentum=MOMENTUM),
        accumulate=2, ema=True)
    tstep = tsteps.make_train_step(accumulate=2, ema_decay=0.9)
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}

    for call, (x, y) in enumerate(_batches(4, seed=3, hw=16), start=1):
        jstate, jl = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tl = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        assert tl.dim() == 0 and not tl.requires_grad
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert (tstate.step, tstate.micro_step) == (call // 2, call) == (
            int(jstate.step), int(jstate.micro_step))
        if call == 1:  # no update yet: the weights have not moved
            assert all(torch.equal(v, start[k]) for k, v in
                       tmodel.state_dict().items() if "bn.running" not in k
                       and "num_batches" not in k)
        want = state_dict_from_jax(_numpy_tree(jstate.params),
                                   _numpy_tree(jstate.batch_stats))
        _assert_state_dicts_close(tmodel.state_dict(), want, 1e-5, 1e-6)
        want_ema = state_dict_from_jax(_numpy_tree(jstate.ema_params), {})
        _assert_state_dicts_close(tstate.ema_params, want_ema, 1e-5, 1e-6)
    assert all(not a.any() for a in tstate.grad_acc)  # window closed
    assert any(not torch.equal(v, tstate.ema_params[k])
               for k, v in tmodel.named_parameters())

    with pytest.raises(ValueError, match="accumulate=k"):
        tstep(tsteps.create_train_state(tmodel, tstate.optimizer),
              torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(ValueError, match="ema=True"):
        tsteps.make_train_step(ema_decay=0.5)(
            tsteps.create_train_state(tmodel, tstate.optimizer),
            torch.from_numpy(x), torch.from_numpy(y))


def _jax_module(full_res_output=True):
    return JaxDeepLabV3Plus(num_classes=NC, backbone_layers=LAYERS,
                            dtype=jnp.float32,
                            full_res_output=full_res_output)


def _port_module(full_res_output=True):
    return build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                       dtype=torch.float32, full_res_output=full_res_output)


@pytest.fixture(scope="module")
def start_weights(tmp_path_factory):
    """The training start both packages share, as a state_dict, as JAX trees
    and saved as a `.pt`: BN at its init (weight 1, bias 0, mean 0, var 1)
    and conv kernels uniform in +-1/sqrt(fan_in), torch's default, which
    tests/test_train_parity.py starts from too. At this size (layer3/4 and
    ASPP normalize 4x4 maps over batch 2, the pool branch two values per
    channel) the f32 gradient is badly conditioned under the He fan-out
    kernels: both packages then sit 10% from an f64 gradient in single
    tensors, and their trajectories part within two steps."""
    sd = seeded_state_dict(_port_module(), seed=0, init="uniform")
    bn_init = seeded_state_dict(_port_module(), seed=0, init="train")
    sd.update({k: v for k, v in bn_init.items()
               if ".bn." in k or k.endswith(".bias")})
    params, stats = jax_trees_from_state_dict(sd)
    path = str(tmp_path_factory.mktemp("train") / "start.pt")
    torch.save({"model": sd}, path)
    return sd, params, stats, path


@pytest.fixture(scope="module")
def jax_trajectory(start_weights):
    """6 SGD-momentum steps of the JAX package on full-resolution logits
    with compute_loss (its default step): losses and the final state as the
    port's state_dict. The Trainer's deferred upsample is the same function
    (the upsample is linear and last), so both routes of the port are held
    to this one trajectory."""
    _, params, stats, _ = start_weights
    module = _jax_module()
    state = _jax_state(module, {"params": params, "batch_stats": stats},
                       optax.sgd(LR, momentum=MOMENTUM))
    step = jsteps.make_train_step(loss_fn=jax_compute_loss, donate=False)
    losses = []
    for x, y in _batches(N_STEPS, seed=4):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses, state_dict_from_jax(_numpy_tree(state.params),
                                       _numpy_tree(state.batch_stats))


def _assert_trajectory(losses, model, jax_trajectory, start):
    want_losses, want = jax_trajectory
    # f32 on both sides; convolutions and reductions sum in another order
    # (measured: 2e-5 at most)
    np.testing.assert_allclose(losses, want_losses, rtol=5e-4)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    # tests/test_train_parity.py's tolerances for deeplabv3plus, here on
    # every tensor: parameters rtol 5e-3 / atol 5e-4, BN running mean atol
    # 0.03, running variance rtol 0.05 / atol 0.05
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == N_STEPS, k
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(got[k], w, atol=0.03, err_msg=k)
        elif k.endswith("running_var"):
            np.testing.assert_allclose(got[k], w, rtol=0.05, atol=0.05,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=5e-4,
                                       err_msg=k)
    # Sharper, since 6 updates at lr 1e-3 move a weight by less than those
    # tolerances. The running statistics moved by ~0.4 and agree to 1e-5
    # (measured); the class conv's update (final - start) agrees to 6e-4 of
    # its largest entry; all updates jointly to 1.5-2.5% in norm (the small
    # updates of convolutions that feed a BatchNorm over 32 samples are
    # sums that cancel, and differ by a third between the packages). A wrong
    # rate, momentum or unbiased-variance factor misses these by far.
    num = den = 0.0
    for k, w in want.items():
        if "running_" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            moved, want_moved = got[k] - start[k].numpy(), w - start[k].numpy()
            num += float(((moved - want_moved) ** 2).sum())
            den += float((want_moved ** 2).sum())
            if k.startswith("cls_conv"):
                assert (np.abs(moved - want_moved).max()
                        <= 0.01 * np.abs(want_moved).max()), k
    assert den > 0 and np.sqrt(num / den) <= 0.1, np.sqrt(num / den)


def test_sgd_trajectory_full_res_matches_jax(start_weights, jax_trajectory):
    model = _port_module()
    model.load_state_dict(start_weights[0])
    state = tsteps.create_train_state(
        model, ttrainer.make_optimizer(model.parameters(), lr=LR,
                                       momentum=MOMENTUM))
    step = tsteps.make_train_step(loss_fn=compute_loss)
    losses = []
    for x, y in _batches(N_STEPS, seed=4):
        state, loss = step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(loss))
    assert state.step == N_STEPS
    _assert_trajectory(losses, model, jax_trajectory, start_weights[0])


class _Fetcher:
    """In-memory fetcher: yields (images, segs, valid) and has a length."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return ((x, y, len(x)) for x, y in self.batches)


def test_trainer_deferred_upsample_trajectory_and_round_trip(
        start_weights, jax_trajectory, tmp_path, monkeypatch):
    """A full_res_output=True model handed to the Trainer trains its
    stride-4 twin through make_loss_fn (the fused wrapper); one epoch per
    batch gives the per-step losses. Then log.jsonl, save -> serve, and a
    warm start."""
    from pytorch_segmentation_tpu_torch.ops import loss as tloss
    fused_calls = []
    real = tloss.fused_upsample_ce
    monkeypatch.setattr(tloss, "fused_upsample_ce", lambda *a, **k: (
        fused_calls.append(a[0].shape), real(*a, **k))[1])

    model = _port_module(full_res_output=True)
    batches = _batches(N_STEPS, seed=4)
    fetcher = _Fetcher(batches[:1])
    trainer = ttrainer.Trainer(
        model, fetcher, workdir=str(tmp_path / "w"), lr=LR,
        momentum=MOMENTUM, weights=start_weights[3], log=False,
        log_dir=str(tmp_path / "runs"), device="cpu")
    assert trainer._train_module.full_res_output is False
    assert model.full_res_output is True
    assert all(a is b for a, b in zip(trainer._train_module.parameters(),
                                      model.parameters()))
    losses = []
    for i in range(N_STEPS):
        fetcher.batches = batches[i:i + 1]
        losses.append(trainer.step())
    assert fused_calls == [(BS, HW // 4, HW // 4, NC)] * N_STEPS
    assert trainer.epoch == N_STEPS and trainer.state.step == N_STEPS
    _assert_trajectory(losses, model, jax_trajectory, start_weights[0])

    # log.jsonl: the JAX trainer's record, read off its own step() run on a
    # stub with an empty fetcher
    stub = types.SimpleNamespace(
        fetcher=[], log=False, profile=False, epoch=0,
        log_dir=str(tmp_path / "jax_runs"), _lr_at=lambda s: LR,
        state=types.SimpleNamespace(step=0))
    stub.log_record = functools.partial(jtrainer.Trainer.log_record, stub)
    jtrainer.Trainer.step(stub)
    want_keys = set(json.loads(
        (tmp_path / "jax_runs" / "log.jsonl").read_text()))
    records = [json.loads(line) for line in
               (tmp_path / "runs" / "log.jsonl").read_text().splitlines()]
    assert len(records) == N_STEPS
    assert set(records[0]) == want_keys
    assert records[-1]["epoch"] == N_STEPS - 1 and records[-1]["steps"] == 1
    np.testing.assert_allclose(records[-1]["loss"], losses[-1])
    assert records[-1]["lr"] == LR

    # save -> load_model_bundle -> make_mask_fn
    trainer.metrics = 0.5
    trainer.save(best=True)
    last = tmp_path / "w" / "last.pt"
    assert (tmp_path / "w" / "best.pt").exists()
    ckpt = torch.load(last, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "step", "epoch", "best_miou",
                         "ema"}
    assert ckpt["epoch"] == ckpt["step"] == N_STEPS
    assert ckpt["best_miou"] == 0.5
    assert ckpt["ema"] is None and ckpt["optimizer"]["state"]
    served = load_model_bundle(_port_module(False), str(last), "cpu")
    for k, v in served.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    imgs = np.random.default_rng(5).integers(0, 256, (2, HW, HW, 3),
                                             dtype=np.uint8)
    masks = make_mask_fn(served)(imgs)
    assert masks.shape == (2, HW, HW) and int(masks.max()) < NC
    assert torch.equal(masks, make_mask_fn(trainer.model)(imgs))
    assert trainer.ema_model is trainer.model  # EMA off

    # warm start: the checkpoint's tensors; a module the checkpoint lacks
    # keeps its seeded start
    sd = load_state(str(last))
    partial = {k: v for k, v in sd.items() if not k.startswith("cls_conv")}
    torch.save({"model": partial}, tmp_path / "partial.pt")
    warm = ttrainer.Trainer(_port_module(), _Fetcher([]), log=False,
                            weights=str(tmp_path / "partial.pt"),
                            device="cpu", ema_decay=0.9,
                            log_dir=str(tmp_path / "runs2"))
    got = warm.module.state_dict()
    seeded = seeded_state_dict(_port_module(), seed=0, init="train")
    for k, v in got.items():
        want = seeded[k] if k.startswith("cls_conv") else sd[k]
        assert torch.equal(v, want), k
    ema = warm.ema_model
    assert ema is not warm.module and not ema.training
    assert torch.equal(ema.cls_conv.weight, got["cls_conv.weight"])
    torch.save({"model": {**sd, "extra.weight": torch.zeros(1)}},
               tmp_path / "extra.pt")
    with pytest.raises(ValueError, match="extra.weight"):
        ttrainer.Trainer(_port_module(), _Fetcher([]), device="cpu",
                         weights=str(tmp_path / "extra.pt"))


def test_custom_loss_keeps_the_full_resolution_model(tmp_path):
    loss_fn = lambda logits, segs: compute_loss(logits, segs)
    trainer = ttrainer.Trainer(_port_module(), _Fetcher([]), loss_fn=loss_fn,
                               device="cpu", log=False,
                               log_dir=str(tmp_path))
    assert trainer._train_module is trainer.module
    off = ttrainer.Trainer(_port_module(), _Fetcher([]), device="cpu",
                           defer_upsample=False, log=False,
                           log_dir=str(tmp_path))
    assert off._train_module is off.module


def test_weight_trees_round_trip(start_weights):
    sd, params, stats, _ = start_weights
    back = state_dict_from_jax(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.numpy().dtype, k
        assert np.array_equal(back[k], v.numpy()), k
    # and from the JAX side: trees -> state_dict -> trees is the identity
    shapes = jax.eval_shape(
        lambda k, x: _jax_module().init({"params": k}, x, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3), jnp.float32))
    rng = np.random.default_rng(6)
    trees = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    p2, s2 = jax_trees_from_state_dict(
        state_dict_from_jax(trees["params"], trees["batch_stats"]))
    again = {"params": p2, "batch_stats": s2}
    assert (jax.tree.structure(again) == jax.tree.structure(trees))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(again), jax.tree.leaves(trees)))
    with pytest.raises(ValueError, match="unmapped"):
        jax_trees_from_state_dict({"x.gamma": np.zeros(1)})


@pytest.mark.parametrize("init", ["serve", "train", "uniform"])
def test_seeded_state_dict_starts(init):
    model = _port_module()
    sd = seeded_state_dict(model, seed=3, init=init)
    again = seeded_state_dict(model, seed=3, init=init)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    model.load_state_dict(sd)  # strict: every entry, right shapes
    bn, kernel = sd["backbone.stem.bn.weight"], sd["cls_conv.weight"]
    assert bool((bn == 1).all()) == (init == "train")
    fan_in = kernel[0].numel()
    assert (float(kernel.abs().max()) <= fan_in ** -0.5) == (init == "uniform")
    with pytest.raises(ValueError, match="init must be"):
        seeded_state_dict(model, seed=3, init="he")


def test_unported_train_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsteps.make_train_step(qat=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsteps.make_train_step(distill_fn=lambda x: x)
    for option in ("mesh", "zero", "qat", "distill_fn"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrainer.Trainer(_TorchTiny(), _Fetcher([]), device="cpu",
                             **{option: object()})
    with pytest.raises(TypeError, match="unknown option"):
        ttrainer.Trainer(_TorchTiny(), _Fetcher([]), device="cpu", typo=1)

    class Aux(torch.nn.Module):  # a train-mode forward with an aux head
        def __init__(self):
            super().__init__()
            self.inner = _TorchTiny()

        def forward(self, x):
            return self.inner(x), self.inner(x)

    # auxiliary heads are ported: the step takes main + aux_weight * aux,
    # and the eval and serving paths refuse a forward that returns a tuple
    aux = Aux()
    state = tsteps.create_train_state(
        aux, ttrainer.make_optimizer(aux.parameters(), lr=0.0))
    x, y = (torch.from_numpy(a) for a in _batches(1, seed=7, hw=16)[0])
    _, loss = tsteps.make_train_step(aux_weight=0.25)(state, x, y)
    with torch.no_grad():
        logits = aux.inner(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(loss, 1.25 * compute_loss(logits, y))
    with pytest.raises(ValueError, match="returned a tuple"):
        tsteps.nhwc_forward(aux.eval())(x)


def test_held_model_after_a_step_is_refused_by_the_eval_paths():
    """A module held from `trainer.model` before a step: the step trains
    the stride-4 twin, a shallow copy that shares the held module's
    children, and puts them back in train mode while the held module's own
    flag stays False. The eval step, the predict step and both mask
    functions look at every submodule and refuse it; `trainer.model` again
    is in eval mode throughout."""
    model = _TorchTiny()
    model.full_res_output = True    # so that the Trainer makes the twin
    trainer = ttrainer.Trainer(model, _Fetcher(_batches(1, seed=13, hw=16)),
                               device="cpu", log=False)
    assert trainer._train_module is not model
    held = trainer.model
    trainer.step()
    assert not held.training and held.block.training
    x, y = (torch.from_numpy(a) for a in _batches(1, seed=14, hw=16)[0])
    imgs = np.random.default_rng(15).integers(0, 256, (BS, 16, 16, 3),
                                              dtype=np.uint8)
    calls = {
        "the eval step": lambda m: tsteps.make_eval_step(NC)(m, x, y, BS),
        "the predict step": lambda m: tsteps.make_predict_step()(
            m, x, (16, 16)),
        "make_mask_fn": lambda m: make_mask_fn(m)(imgs),
        "make_tiled_mask_fn": lambda m: make_tiled_mask_fn(
            m, tile_hw=(16, 16))(imgs)}
    for what, call in calls.items():
        with pytest.raises(ValueError, match=f"{what} needs an eval-mode "
                           f"module: a submodule is in train mode"):
            call(held)
    fresh = trainer.model
    assert fresh is held and not any(m.training for m in fresh.modules())
    for call in calls.values():
        call(fresh)


def test_trainer_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.Trainer(_TorchTiny(), _Fetcher([]))


def test_trainer_takes_the_train_cli_options(tmp_path):
    """The options the train CLI always passes construct and step a
    Trainer: mixed_precision is ignored (the model's dtype decides),
    aux_weight / distill_weight / distill_temp are inert, also at a
    distill_weight without a distill_fn, as in the JAX Trainer; a name
    neither package knows still raises."""
    losses = []
    for distill_weight in (0.0, 0.5):
        trainer = ttrainer.Trainer(
            _TorchTiny(), _Fetcher(_batches(2, seed=11, hw=16)),
            mixed_precision=True, aux_weight=0.4,
            distill_weight=distill_weight, distill_temp=2.0, device="cpu",
            log_dir=str(tmp_path), log=False, seed=3)
        losses.append(trainer.step())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    with pytest.raises(TypeError, match="unknown option"):
        ttrainer.Trainer(_TorchTiny(), _Fetcher([]), device="cpu",
                         mixed_precison=True)


def test_trainer_copies_host_batches_through_pinned_memory(monkeypatch):
    """numpy batches arrive equal; a tensor already on the device passes
    through untouched; for the card a host array is pinned first and copied
    without blocking (the copy of pageable memory would wait for the whole
    stream). The card's half is checked by recording the two calls."""
    trainer = ttrainer.Trainer(_TorchTiny(), _Fetcher([]), device="cpu")
    x, y = _batches(1, seed=12, hw=16)[0]
    for array in (x, y):
        got = trainer._to_device(array)
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy(), array)
    on_device = torch.from_numpy(x)
    assert trainer._to_device(on_device) is on_device

    seen = []

    def pin_memory(self):
        seen.append("pin")
        return self

    def to(self, device, non_blocking=False):
        seen.append((torch.device(device).type, non_blocking))
        return self

    monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
    monkeypatch.setattr(torch.Tensor, "to", to)
    trainer.device = torch.device("cuda")
    assert np.array_equal(trainer._to_device(x).numpy(), x)
    assert seen == ["pin", ("cuda", True)]
