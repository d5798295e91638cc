"""PyTorch port: data parallelism (parallel/mesh.py, parallel/zero.py, the
train step, Trainer, test(), the losses and the serving paths under a mesh)
on the CPU.

Two gloo ranks, spawned once for the module, run every scenario of
tests/torch_parallel_ranks.py on their shards of the same global batches;
each result is held against the port's single-process run on the
concatenated global batch, and the plain step also against the JAX package's
step on a two-device CPU mesh. f32 throughout. A rank's step differs from the
single-process one only in the order of the sums that the all-reduces split
(BatchNorm's moments, the loss ratios, the gradients), so the losses hold to
a relative 1e-5 and the parameters and running statistics to a relative 1e-5
with an absolute 1e-6 for entries near zero; the eval counts are integers and
equal exactly."""

import json
import os
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks_mod
from pytorch_segmentation_tpu.engine import steps as jsteps
from pytorch_segmentation_tpu.nn import blocks as jblocks
from pytorch_segmentation_tpu.ops.loss import compute_loss as jax_compute_loss
from pytorch_segmentation_tpu.parallel.zero import (
    zero_leaf_spec as jax_zero_leaf_spec)
from pytorch_segmentation_tpu_torch.inference import make_mask_fn
from pytorch_segmentation_tpu_torch.parallel import (data_sharding, make_mesh,
                                                     put_global_batch,
                                                     shard_batch,
                                                     zero_leaf_spec)
from pytorch_segmentation_tpu_torch.parallel.mesh import (
    initialize_distributed)
from pytorch_segmentation_tpu_torch.serving import MaskServer
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, state_dict_from_jax)
from torch_family_util import FAST_COMPILE

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, from one spawn of two gloo processes that
    meet at a FileStore under the test's own directory; while they run,
    every scenario in this process on the global batches and the JAX
    package's step on a two-device mesh."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    ctx = torch.multiprocessing.start_processes(
        ranks_mod.rank_main, args=(tmp,), nprocs=ranks_mod.WORLD,
        join=False, start_method="spawn")
    try:
        ref_tmp = str(tmp_path_factory.mktemp("reference"))
        reference = (ref_tmp, ranks_mod.scenarios(None, ref_tmp))
        jax_step = _jax_step()
    finally:
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError("the two gloo ranks did not finish")
    ranks = (tmp, [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                              weights_only=False)
                   for r in range(ranks_mod.WORLD)])
    return ranks, reference, jax_step


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


def _assert_states_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(w), k
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("scenario", ["plain", "accumulate", "folded",
                                      "weighted_ce"])
def test_two_ranks_step_as_one_process_on_the_global_batch(
        ranks, reference, scenario):
    """One step; 4 calls at accumulate=2; the folded path (switch on, kernel
    5's plain version); CE with class weights and ignore_index on shards
    with uneven valid pixels. Both ranks return the global loss and end on
    the same state, the single process's."""
    want = reference[1][scenario]
    for r in ranks[1]:
        got = r[scenario]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
        _assert_states_close(got["state"], want["state"])


def test_zero_trainer_as_replicated_and_its_checkpoint(ranks, reference):
    """Trainer(zero=True) over two ranks, EMA 0.9 and a clip of 0.5 (which
    bites), 3 steps: its loss, and the file it saves (parameters, the
    gathered momentum, the gathered EMA) are the single process's; a
    Trainer resumed from the file holds the same optimizer state."""
    want = reference[1]["zero"]
    for r in ranks[1]:
        assert r["zero"]["sharded"]
        np.testing.assert_allclose(r["zero"]["loss"], want["loss"],
                                   rtol=RTOL)
    got = ranks[1][0]["zero"]["ckpt"]
    assert not want["sharded"]
    assert want["ckpt"]["step"] == got["step"] == 3
    _assert_states_close(got["model"], want["ckpt"]["model"])
    _assert_states_close(got["ema"], want["ckpt"]["ema"])
    for ckpt in (got, want["ckpt"]):   # same layout, full-size leaves
        momentum = {i: e["momentum_buffer"]
                    for i, e in ckpt["optimizer"]["state"].items()}
        assert momentum.keys() == want["ckpt"]["optimizer"]["state"].keys()
    _assert_states_close(
        {str(i): e["momentum_buffer"]
         for i, e in got["optimizer"]["state"].items()},
        {str(i): e["momentum_buffer"]
         for i, e in want["ckpt"]["optimizer"]["state"].items()})
    for r in ranks[1]:
        resumed = r["zero"]["resumed"]["state"]
        for i, e in got["optimizer"]["state"].items():
            assert torch.equal(resumed[i]["momentum_buffer"],
                               e["momentum_buffer"])


def test_eval_counts_over_two_ranks_are_exact(ranks, reference):
    """test(mesh=) over 10 records in global batches of 8, 5 a rank (its
    second batch padded from 1 to 4), against one process at batch 8 (8,
    then 2 padded): the confusion counts and the mIoU equal exactly, the
    loss to rounding; the report is rank 0's."""
    with open(os.path.join(ranks[0], "report.json")) as f:
        got = json.load(f)
    with open(os.path.join(reference[0], "report.json")) as f:
        want = json.load(f)
    for g, w in zip(got["per_class"], want["per_class"]):
        assert (g["tp"], g["fn"], g["fp"]) == (w["tp"], w["fn"], w["fp"])
    assert got["miou"] == want["miou"]
    assert all(r["eval"]["miou"] == want["miou"] for r in ranks[1])
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=RTOL)


RAISING = ("ohem", "lovasz")


@pytest.mark.parametrize("name", list(ranks_mod.loss_functions()))
def test_each_loss_is_global_over_two_ranks_or_raises(ranks, reference,
                                                      name):
    """Loss by loss on shards with uneven ignored pixels: the ranks' mean
    value is the global batch's and their gradients, over the rank count,
    are its gradient (a ratio of batch sums takes both sums over the ranks;
    a mean over equal shards follows from the step's average). OHEM and
    Lovász need the whole batch at once and raise, naming item 10."""
    got = [r["losses"][name] for r in ranks[1]]
    if name in RAISING:
        assert all(isinstance(g, str) and "item 10," in g for g in got), got
        return
    value, grad = reference[1]["losses"][name]
    np.testing.assert_allclose(np.mean([g[0] for g in got]), value,
                               rtol=RTOL)
    np.testing.assert_allclose(
        torch.cat([g[1] for g in got]).numpy() / ranks_mod.WORLD,
        grad.numpy(), rtol=RTOL, atol=ATOL * float(grad.abs().max()))


class _JaxTiny(fnn.Module):
    """`torch_parallel_ranks.TinyNet` in the JAX package's blocks."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = jblocks.ConvNormAct(ranks_mod.WIDTH, 3, stride=2,
                                dtype=jnp.float32, name="stem")(x, train)
        x = jblocks.ConvNormAct(ranks_mod.WIDTH, 3, dtype=jnp.float32,
                                name="mid")(x, train)
        return fnn.Conv(ranks_mod.NC, (1, 1), name="cls")(x)


def _jax_step():
    """The JAX package's train step of `_JaxTiny` from the ranks' start
    (utils/weights), on a two-device CPU mesh with the global batch sharded
    over 'data': the loss and the state as the port's state_dict."""
    start = {k: v.detach().numpy()
             for k, v in ranks_mod.tiny_net().state_dict().items()}
    params, stats = jax_trees_from_state_dict(start)
    tx = optax.sgd(ranks_mod.LR, momentum=ranks_mod.MOMENTUM)
    module = _JaxTiny()
    state = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jax.jit(tx.init)(params), tx=tx, apply_fn=module.apply,
        grad_acc=None, micro_step=jnp.zeros((), jnp.int32), ema_params=None)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    images, segs = ranks_mod.global_batches(1, seed=5)[0]
    batch = NamedSharding(mesh, P("data"))
    args = (state, jax.device_put(images, batch),
            jax.device_put(segs.astype(np.int32), batch))
    step = jsteps.make_train_step(
        loss_fn=lambda lg, y: jax_compute_loss(lg, y, align_corners=True),
        donate=False)
    state, loss = step.lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    return float(loss), state_dict_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats))


def test_two_ranks_step_matches_jax_on_a_two_device_mesh(ranks, runs):
    """The ranks' plain step against the JAX package's train step of the
    same network, from the same weights (utils/weights), on a two-device
    CPU mesh with the batch sharded over 'data' (`_jax_step`): the loss to
    a relative 1e-5, parameters and statistics as the single-process
    comparison (tighter than tests/test_parallel.py's 1e-3 / 5e-2)."""
    loss, want = runs[2]
    for r in ranks[1]:
        got = r["plain"]
        np.testing.assert_allclose(got["losses"][0], loss, rtol=RTOL)
        # the JAX state has no num_batches_tracked
        keys = [k for k in want if not k.endswith("num_batches_tracked")]
        _assert_states_close({k: got["state"][k] for k in keys},
                             {k: torch.tensor(np.asarray(want[k]))
                              for k in keys})


@pytest.mark.parametrize("shape,n", [
    ((3, 3, 64, 128), 8), ((64,), 8), ((21,), 8), ((), 8), ((8, 512), 8),
    ((2048, 512, 1, 1), 4), ((21, 256, 1, 1), 2), ((7, 5), 3)])
def test_zero_leaf_spec_matches_jax(shape, n):
    """The largest n-divisible dimension, by the JAX function itself."""
    want = jax_zero_leaf_spec(jnp.zeros(shape), n)
    assert zero_leaf_spec(torch.zeros(shape), n) == tuple(want)


def test_mesh_serving_equals_one_device_and_refuses_what_jax_refuses():
    """make_mask_fn and MaskServer over a one-device and a two-replica CPU
    mesh give the masks of the plain path; a batch that does not divide by
    the card count raises; int8 with TTA under a mesh raises the JAX
    ValueError; MaskServer rounds max_batch up to the card count."""
    model = ranks_mod.tiny_net().eval()
    images = np.random.default_rng(4).integers(
        0, 256, (4, ranks_mod.HW, ranks_mod.HW, 3), dtype=np.uint8)
    plain = make_mask_fn(model)(images)
    one, two = make_mesh(devices=["cpu"]), make_mesh(devices=["cpu", "cpu"])
    for mesh in (one, two):
        assert torch.equal(make_mask_fn(model, mesh=mesh)(images), plain)
    with pytest.raises(ValueError, match="divisible"):
        make_mask_fn(model, mesh=two)(images[:3])
    server = MaskServer(model, img_size=(ranks_mod.HW, ranks_mod.HW),
                        max_batch=3, mesh=two)
    assert server.max_batch == 4
    assert np.array_equal(server._run_batch(images), plain.numpy())
    with pytest.raises(ValueError, match="int8"):
        MaskServer(model, int8=True, tta_flip=True, mesh=one)


def test_mesh_helpers_on_one_process(monkeypatch):
    """Without torchrun's environment there is no process group; a mesh of
    one process takes all rows; --spatial's mesh is not ported."""
    monkeypatch.delenv("RANK", raising=False)
    assert initialize_distributed(device="cpu") is None
    mesh = make_mesh(devices=["cpu"])
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    x = np.arange(12).reshape(4, 3)
    assert torch.equal(shard_batch(mesh, x), torch.from_numpy(x))
    sharding = data_sharding(mesh)
    assert (sharding.rank, sharding.world) == (0, 1)
    assert put_global_batch(sharding, x).device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="item 10,"):
        make_mesh(devices=["cpu"], spatial=2)
