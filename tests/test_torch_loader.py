"""PyTorch port: the host loader (`DataLoader`, `Fetcher`,
`repeat_factors`), `multi_scale_sizes` and `PostFetch` against the JAX
package's classes on the same in-memory dataset (CPU), and the `Trainer` fed
by `Fetcher(DataLoader(...), PostFetch(augment_fn=...))`."""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.data import loader as jloader
from pytorch_segmentation_tpu.data import pipeline as jpipe
from pytorch_segmentation_tpu.data import resize_host as jresize
from pytorch_segmentation_tpu_torch import data as tdata
from pytorch_segmentation_tpu_torch.data import loader as tloader
from pytorch_segmentation_tpu_torch.data.augment import (AugmentConfig,
                                                         make_augment_fn)
from pytorch_segmentation_tpu_torch.data.pipeline import (PostFetch,
                                                          _batch_seed)
from pytorch_segmentation_tpu_torch.data.resize_host import multi_scale_sizes
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.models import (build_model,
                                                   without_default_init)
from pytorch_segmentation_tpu_torch.parallel import (DataSharding,
                                                     data_sharding, make_mesh)

torch.set_num_threads(1)


class MemoryDataset:
    """n (image u8 [H, W, 3], label u8 [H, W]) pairs made from a seed; the
    image's first pixel holds the sample's index."""

    def __init__(self, n, hw=8, classes=5, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
        self.images[:, 0, 0, 0] = np.arange(n)
        self.segs = rng.integers(0, classes, (n, hw, hw), dtype=np.uint8)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.segs[i]


LOADER_CASES = {
    "plain_padded": dict(batch_size=4),
    "drop_last": dict(batch_size=4, drop_last=True),
    "shuffled": dict(batch_size=3, shuffle=True, seed=7),
    "shuffled_drop_last": dict(batch_size=4, shuffle=True, drop_last=True,
                               seed=1, num_workers=2),
    "rank_1_of_3": dict(batch_size=2, rank=1, world_size=3),
    "shuffled_rank_0_of_2": dict(batch_size=3, shuffle=True, seed=3, rank=0,
                                 world_size=2),
    "repeat_factors": dict(batch_size=4, shuffle=True, seed=5,
                           repeat_factors=np.linspace(1.0, 2.6, 10)),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_dataloader_equals_the_jax_package(case):
    """numpy on both sides: the same batches, padding, `valid` counts and
    lengths, over two epochs (shuffling is by (seed, epoch))."""
    ds = MemoryDataset(10)
    ours = tloader.DataLoader(ds, **LOADER_CASES[case])
    theirs = jloader.DataLoader(ds, **LOADER_CASES[case])
    seen = []
    for _ in range(2):
        assert len(ours) == len(theirs)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert isinstance(g, tloader.Batch) and g.valid == w.valid
            assert g.images.dtype == np.uint8 and g.segs.dtype == np.uint8
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.segs, w.segs)
        seen.append([b.images[:, 0, 0, 0].tolist() for b in got])
    assert ours.epoch == theirs.epoch == 2
    if LOADER_CASES[case].get("shuffle"):
        assert seen[0] != seen[1]
    bs = LOADER_CASES[case]["batch_size"]
    assert all(len(ids) == bs for epoch in seen for ids in epoch)


def test_padding_and_valid_counts():
    loader = tloader.DataLoader(MemoryDataset(10), batch_size=4)
    batches = list(loader)
    assert [b.valid for b in batches] == [4, 4, 2]
    assert batches[-1].images[:, 0, 0, 0].tolist() == [8, 9, 8, 9]
    assert len(tloader.DataLoader(MemoryDataset(10), 4, drop_last=True)) == 2


def test_repeat_factors_equal_the_jax_package():
    presence = [{0, 1}, {1}, {2}, set(), {0, 2, 3}, {1}]
    for t in (0.1, 0.5, 1.0):
        np.testing.assert_array_equal(
            tloader.repeat_factors(presence, len(presence), t),
            jloader.repeat_factors(presence, len(presence), t))


def test_multi_scale_sizes_equal_the_jax_package():
    for base in ((513, 513), (64, 64), (320, 480)):
        assert multi_scale_sizes(base) == jresize.multi_scale_sizes(base)
    assert all(h % 32 == 0 and w % 32 == 0
               for h, w in multi_scale_sizes((513, 513)))


def test_fetcher_applies_the_hook_and_prefetches():
    loader = tloader.DataLoader(MemoryDataset(10), batch_size=4)
    calls = []

    def hook(batch):
        calls.append(threading.current_thread())
        return batch.images[:, 0, 0, 0].tolist(), batch.valid

    fetcher = tloader.Fetcher(loader, hook, prefetch=2)
    assert len(fetcher) == 3 and fetcher.loader is loader
    assert list(fetcher) == [([0, 1, 2, 3], 4), ([4, 5, 6, 7], 4),
                             ([8, 9, 8, 9], 2)]
    # the hook runs in the producer thread, not in the consumer's
    assert all(t is not threading.current_thread() for t in calls)
    assert [b.valid for b in tloader.Fetcher(loader)] == [4, 4, 2]


def test_fetcher_propagates_a_producers_exception():
    def hook(batch):
        if batch.images[0, 0, 0, 0] == 4:
            raise RuntimeError("boom in the hook")
        return batch

    fetcher = tloader.Fetcher(tloader.DataLoader(MemoryDataset(10), 4), hook)
    got = []
    with pytest.raises(RuntimeError, match="boom in the hook"):
        for batch in fetcher:
            got.append(batch.valid)
    assert got == [4]

    class Broken(MemoryDataset):
        def __getitem__(self, i):
            raise KeyError("no such sample")

    with pytest.raises(KeyError):
        list(tloader.Fetcher(tloader.DataLoader(Broken(4), 2)))


def test_fetcher_survives_an_early_break():
    loader = tloader.DataLoader(MemoryDataset(64), batch_size=2)
    fetcher = tloader.Fetcher(loader, prefetch=1)
    before = threading.active_count()
    for n, _ in enumerate(fetcher):
        if n == 1:
            break
    assert threading.active_count() <= before   # the producer has ended
    assert len(list(fetcher)) == 32             # and a fresh pass is whole


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_postfetch_without_augmentation_equals_the_jax_package(dtype):
    ds = MemoryDataset(6, hw=16)
    batch = next(iter(tloader.DataLoader(ds, batch_size=4)))
    want = jpipe.PostFetch(dtype=getattr(jnp, dtype))(batch)
    got = PostFetch(dtype=getattr(torch, dtype), device="cpu")(batch)
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == torch.int32 and got[2] == want[2] == 4
    # (x - mean) / std in f32 on both sides, rounded once to `dtype`. The
    # JAX class jits the function, and XLA divides by a constant by
    # multiplying with its reciprocal: one f32 ulp (2.4e-7 at 2..4), which
    # the rounding to bf16 hides
    np.testing.assert_allclose(
        got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)),
        rtol=2e-7, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_postfetch_multi_scale_picks_the_jax_packages_sizes():
    """The size is drawn on the host by random.Random(seed) on both sides:
    the same sequence, each one of multi_scale_sizes(base_hw), and the same
    nearest-resized pixels."""
    ds = MemoryDataset(4, hw=64)
    batch = next(iter(tloader.DataLoader(ds, batch_size=4)))
    ours = PostFetch(multi_scale=True, base_hw=(64, 64), seed=3, device="cpu")
    theirs = jpipe.PostFetch(multi_scale=True, base_hw=(64, 64), seed=3)
    sizes = set()
    for _ in range(4):
        got, want = ours(batch), theirs(batch)
        assert tuple(got[0].shape) == tuple(want[0].shape)
        assert tuple(got[0].shape[1:3]) in multi_scale_sizes((64, 64))
        assert tuple(got[1].shape) == (4, 64, 64)      # labels keep their size
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=2e-7, atol=0)   # one f32 ulp, as above
        sizes.add(tuple(got[0].shape[1:3]))
    assert len(sizes) > 1


def test_postfetch_randomness_is_a_function_of_seed_and_step():
    assert _batch_seed(3, 5) == _batch_seed(3, 5)
    seeds = {_batch_seed(s, k, stream) for s in range(4) for k in range(50)
             for stream in (0, 1)}
    assert len(seeds) == 400 and all(0 <= v < 2 ** 63 for v in seeds)
    fn = make_augment_fn()
    ds = MemoryDataset(8, hw=32)
    batches = list(tloader.DataLoader(ds, batch_size=4))
    post = PostFetch(fn, seed=2, device="cpu")
    first = [post(b) for b in batches]
    # a resumed run redraws batch 1 without having drawn batch 0
    resumed = PostFetch(fn, seed=2, device="cpu")
    resumed._step = 1
    again = resumed(batches[1])
    assert torch.equal(again[0], first[1][0])
    assert torch.equal(again[1], first[1][1])
    gen, host_gen = post.generators(1)
    direct = fn(gen, torch.from_numpy(batches[1].images),
                torch.from_numpy(batches[1].segs), host_gen=host_gen)
    assert torch.equal(direct[1], first[1][1])


def test_postfetch_device_and_unported_options():
    mix = tdata.make_mix_fn(cutmix_p=0.5)
    assert PostFetch(mix_fn=mix, device="cpu").mix_fn is mix
    # a one-device mesh's sharding: its device, and rank 0 draws what a
    # PostFetch without one draws; another rank draws otherwise
    sharded = PostFetch(sharding=data_sharding(make_mesh(devices=["cpu"])))
    assert sharded.device == torch.device("cpu")
    plain, rank1 = PostFetch(device="cpu"), PostFetch(
        sharding=DataSharding(1, 2, torch.device("cpu")))
    for a, b, c in zip(sharded.generators(3), plain.generators(3),
                       rank1.generators(3)):
        assert a.initial_seed() == b.initial_seed() != c.initial_seed()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PostFetch()   # device=None means the card
    assert PostFetch(device="cpu").device == torch.device("cpu")
    assert set(tdata.__all__) >= {"DataLoader", "Fetcher", "Batch",
                                  "PostFetch", "normalize_images",
                                  "AugmentConfig", "make_augment_fn",
                                  "make_mix_fn"}


def test_trainer_fed_by_loader_fetcher_postfetch_with_augmentation(tmp_path):
    """A small model, two epochs through
    Fetcher(DataLoader, PostFetch(augment_fn)) on the CPU: the default
    policy's batches reach `Trainer.step`, which counts steps and images
    and returns finite losses."""
    ds = MemoryDataset(10, hw=33, classes=3, seed=4)
    loader = tloader.DataLoader(ds, batch_size=4, shuffle=True,
                                drop_last=True, seed=1)
    post = PostFetch(make_augment_fn(AugmentConfig()), seed=1, device="cpu")
    seen = []

    def recording(batch):
        out = post(batch)
        seen.append(out)
        return out

    with without_default_init():   # the Trainer seeds every entry
        model = build_model("deeplabv3plus", 3, backbone_layers=(1, 1, 1, 1),
                            dtype=torch.float32, full_res_output=True)
    trainer = Trainer(model, tloader.Fetcher(loader, recording), lr=1e-3,
                      log=False, log_dir=str(tmp_path / "runs"),
                      workdir=str(tmp_path / "w"), device="cpu")
    losses = [trainer.step(), trainer.step()]
    assert all(np.isfinite(losses))
    assert trainer.state.step == 4 and trainer.epoch == 2 and len(seen) == 4
    for images, segs, valid in seen:
        assert images.shape == (4, 33, 33, 3) and images.dtype == torch.float32
        assert segs.shape == (4, 33, 33) and segs.dtype == torch.int32
        assert valid == 4 and set(segs.unique().tolist()) <= {0, 1, 2}
    assert not torch.equal(seen[0][0], seen[2][0])
    records = [json.loads(line) for line in
               open(tmp_path / "runs" / "log.jsonl")]
    assert [r["steps"] for r in records] == [2, 2]
    # images_seen = valid samples per epoch: 8 of the 10 with drop_last
    assert all(abs(r["images_per_sec"] * r["seconds"] - 8) < 1e-6
               for r in records)
