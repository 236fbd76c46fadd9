"""The port's data modules (``repro_torch.data``) against the reference's
(``repro.data``): the same seeds and arguments give bit-equal arrays --
procedural images, domain transforms, synthetic generators -- and the
loaders yield the same batches at every step and shard.  Nothing here
touches the network: CelebA's fetcher needs a local raw copy and raises
without one, and every other dataset is procedural or read from a cache
written by the test."""

import numpy as np
import pytest

from repro.data import datasets as ref_ds
from repro.data import synthetic as ref_syn
from repro.data.pipeline import ShardedLoader as RefShardedLoader
from repro_torch.configs import get_config
from repro_torch.data import datasets, synthetic
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.launch.train import train_data


def _spec(s):
    return (s.name, s.height, s.width, s.channels, s.num_classes,
            s.train_size, s.test_size, s.num_dims)


def _same_dataset(a, b):
    assert _spec(a.spec) == _spec(b.spec)
    assert a.source == b.source
    for split in ("train", "valid", "test"):
        for x, y in zip(a.split(split), b.split(split)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_specs_are_the_reference_specs():
    assert set(datasets.SPECS) == set(ref_ds.SPECS)
    for name, spec in datasets.SPECS.items():
        assert _spec(spec) == _spec(ref_ds.SPECS[name])
    assert datasets.VALID_FRACTION == ref_ds.VALID_FRACTION
    assert datasets.DEFAULT_DATA_DIR == ref_ds.DEFAULT_DATA_DIR


@pytest.mark.parametrize("name", ["mnist", "svhn", "celeba"])
@pytest.mark.parametrize("seed", [0, 3])
def test_procedural_images_bit_equal_reference(name, seed):
    got_x, got_y = datasets.procedural_images(datasets.SPECS[name], 48, seed)
    want_x, want_y = ref_ds.procedural_images(ref_ds.SPECS[name], 48, seed)
    assert got_x.dtype == np.uint8 and got_x.shape == want_x.shape
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_y, want_y)


@pytest.mark.parametrize("name", ["mnist", "celeba"])
def test_procedural_dataset_matches_reference(name):
    got = datasets.load_image_dataset(name, source="procedural", size_cap=300)
    want = ref_ds.load_image_dataset(name, source="procedural", size_cap=300)
    _same_dataset(got, want)
    assert len(got.valid_x) == max(1, int(300 * datasets.VALID_FRACTION))


def test_npz_cache_is_read_as_the_reference_reads_it(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {"train_x": rng.randint(0, 256, (40, 32, 32, 3), np.uint8),
              "train_y": np.zeros(40, np.int32),
              "test_x": rng.randint(0, 256, (12, 32, 32, 3), np.uint8),
              "test_y": np.zeros(12, np.int32)}
    np.savez(tmp_path / "celeba.npz", **arrays)
    got = datasets.load_image_dataset("celeba", data_dir=str(tmp_path))
    want = ref_ds.load_image_dataset("celeba", data_dir=str(tmp_path))
    assert got.source == "cache"
    _same_dataset(got, want)
    capped = datasets.load_image_dataset("celeba", data_dir=str(tmp_path),
                                         size_cap=20)
    _same_dataset(capped, ref_ds.load_image_dataset(
        "celeba", data_dir=str(tmp_path), size_cap=20))


def test_load_image_dataset_errors(tmp_path):
    with pytest.raises(KeyError):
        datasets.load_image_dataset("cifar", source="procedural")
    with pytest.raises(ValueError, match="unknown source"):
        datasets.load_image_dataset("celeba", source="web")
    # CelebA's "download" builds the cache from a local raw copy only: with
    # none under data_dir it fails without touching the network
    with pytest.raises(datasets.DatasetUnavailable, match="procedural"):
        datasets.load_image_dataset("celeba", data_dir=str(tmp_path))
    with pytest.raises(KeyError, match="split"):
        datasets.load_image_dataset(
            "mnist", source="procedural", size_cap=64).split("dev")


@pytest.mark.parametrize("family", ["normal", "binomial", "categorical"])
def test_to_domain_matches_reference(family):
    x = np.random.RandomState(1).randint(0, 256, (5, 4, 4, 3), np.uint8)
    got, off = datasets.to_domain(x, family)
    want, want_off = ref_ds.to_domain(x, family)
    assert got.dtype == np.float32 and got.shape == (5, 48)
    np.testing.assert_array_equal(got, want)
    assert off == want_off


def test_to_domain_rejects_other_families():
    with pytest.raises(ValueError, match="bernoulli"):
        datasets.to_domain(np.zeros((1, 2, 2, 1), np.uint8), "bernoulli")


@pytest.mark.parametrize("shards", [1, 3])
def test_array_loader_matches_reference(shards):
    data = np.arange(50 * 4, dtype=np.float32).reshape(50, 4)
    for shard in range(shards):
        got = datasets.array_loader(data, 12, num_shards=shards,
                                    shard_id=shard, start_step=2)
        want = ref_ds.array_loader(data, 12, num_shards=shards,
                                   shard_id=shard, start_step=2)
        for _ in range(6):
            np.testing.assert_array_equal(next(got)["x"], next(want)["x"])
        for step in (0, 7, 40):
            np.testing.assert_array_equal(got.batch_at(step)["x"],
                                          want.batch_at(step)["x"])
    # shards of one step are disjoint and together tile it
    rows = np.concatenate([
        datasets.array_loader(data, 12, num_shards=shards,
                              shard_id=s).batch_at(1)["x"][:, 0]
        for s in range(shards)])
    assert len(np.unique(rows)) == len(rows)


def test_image_loader_matches_reference():
    got_ds = datasets.load_image_dataset("svhn", source="procedural",
                                         size_cap=128)
    want_ds = ref_ds.load_image_dataset("svhn", source="procedural",
                                        size_cap=128)
    got = datasets.image_loader(got_ds, "valid", 8, family="binomial")
    want = ref_ds.image_loader(want_ds, "valid", 8, family="binomial")
    for step in range(3):
        np.testing.assert_array_equal(got.batch_at(step)["x"],
                                      want.batch_at(step)["x"])


def test_sharded_loader_prefetch_and_skip_ahead():
    def make(step, shard, n):
        return {"x": np.full((n, 2), step * 10 + shard, np.float32)}

    got = ShardedLoader(make, 8, num_shards=2, shard_id=1, start_step=5)
    want = RefShardedLoader(make, 8, num_shards=2, shard_id=1, start_step=5)
    assert got.per_host == want.per_host == 4
    got.start_prefetch()
    try:
        for _ in range(4):
            np.testing.assert_array_equal(got.next_prefetched()["x"],
                                          next(want)["x"])
    finally:
        got.stop()
    assert got._thread is not None and not got._thread.is_alive()
    assert got.step == want.step == 9
    np.testing.assert_array_equal(got.batch_at(2, shard=0)["x"],
                                  want.batch_at(2, shard=0)["x"])
    with pytest.raises(AssertionError):
        ShardedLoader(make, 9, num_shards=2)


@pytest.mark.parametrize("name", ["nltcs", "ad"])
def test_binary_dataset_matches_reference(name):
    np.testing.assert_array_equal(synthetic.binary_dataset(name, 64, seed=2),
                                  ref_syn.binary_dataset(name, 64, seed=2))
    with pytest.raises(KeyError):
        synthetic.binary_dataset("mushrooms", 4)


def test_token_batch_and_mixture_images_match_reference():
    got = synthetic.token_batch(3, 1, 4, 16, 50, seed=2)
    want = ref_syn.token_batch(3, 1, 4, 16, 50, seed=2)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(
        synthetic.gaussian_mixture_images(16, 8, 6, 2, 4, seed=1),
        ref_syn.gaussian_mixture_images(16, 8, 6, 2, 4, seed=1))
    _same_dataset(
        datasets.synthetic_image_dataset(8, 8, 3, 64, 16, seed=1),
        ref_ds.synthetic_image_dataset(8, 8, 3, 64, 16, seed=1))


def test_train_data_falls_back_to_procedural_celeba(tmp_path, capsys):
    cfg = get_config("einet_celeba")
    data = train_data(cfg, 3072, "celeba", str(tmp_path))
    assert "procedural" in capsys.readouterr().out
    want = ref_ds.to_domain(ref_ds.load_image_dataset(
        "celeba", source="procedural").train_x, "normal")[0]
    np.testing.assert_array_equal(data, want)
    # CelebA rows for an MNIST-sized model are refused, naming the configs
    with pytest.raises(SystemExit, match="einet_pd_mnist"):
        train_data(get_config("einet_pd_mnist"), 784, "celeba",
                   str(tmp_path))
