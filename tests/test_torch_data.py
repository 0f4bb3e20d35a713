"""The port's data layer against the JAX package's on the CPU.

* A fixture split written by each package from one seed: the same files,
  the same arrays in every npz (whose zip headers carry the write time) and
  the same bytes in every other file.
* ``make_loaders`` gives batches byte-equal to JAX's over three draws, for
  the vision and the language modality alone, the fused pair and the
  deterministic validation loader.
* The transforms and the dataset statistics match JAX's.
* The ``shm`` cache (the port's g++ build of its copy of the C++ arena)
  gives the ``ram`` cache's batches, its threaded gather too.
* ``DeviceLoader`` on the CPU hands out ``batch_to_device``'s batches, and
  ``batch_to_device`` passes a tensor already on the device as it is.
"""

import pathlib
from dataclasses import astuple

import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.data import dataset as jax_dataset
from hulc_tpu.data import fixtures as jax_fixtures
from hulc_tpu.data import transforms as jax_transforms
from hulc_tpu.data.loader import make_loaders as jax_make_loaders

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.data import dataset, fixtures, shm_store, transforms
from hulc_tpu_torch.data.loader import DeviceLoader, make_loaders
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.training.preprocess import batch_to_device

torch.set_num_threads(1)

JAX_CFG = jax_config.get_config("hulc_debug")
PORT_CFG = port_config.get_config("hulc_debug")
WINDOW = dict(min_window=6, max_window=8)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixtures.make_fixture_dataset(tmp_path_factory.mktemp("port_data"), num_episodes=2, episode_len=24)


def _same_tree(a: pathlib.Path, b: pathlib.Path) -> int:
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files_a == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files_a:
        if rel.suffix == ".npz":
            with np.load(a / rel) as fa, np.load(b / rel) as fb:
                assert sorted(fa.files) == sorted(fb.files), rel
                for k in fa.files:
                    assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, (rel, k)
                    assert fa[k].tobytes() == fb[k].tobytes(), (rel, k)
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return len(files_a)


@pytest.mark.parametrize("learnable", [False, True])
def test_fixture_split_matches_jax(tmp_path, learnable):
    for side, mod in (("jax", jax_fixtures), ("port", fixtures)):
        mod.write_split(tmp_path / side, num_episodes=2, episode_len=20, seed=3, small=True,
                        is_validation=True, learnable=learnable)
    assert _same_tree(tmp_path / "jax", tmp_path / "port") == 2 * 20 + 4


def _fields_equal(got: ModalityBatch, want) -> None:
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert g.tobytes() == w.tobytes(), name


CASES = {
    "vis": dict(modalities=("vis",)),
    "lang": dict(modalities=("lang",)),
    "fused": dict(fuse=True),
    "validation": dict(split="validation", deterministic=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_loaders_matches_jax(root, case):
    kwargs = dict(batch_size=3, seed=7, **WINDOW, **CASES[case])
    got_loader = make_loaders(PORT_CFG, root, **kwargs)
    want_loader = jax_make_loaders(JAX_CFG, root, **kwargs)
    assert len(got_loader) == len(want_loader) >= 3
    draws = 0
    for got, want in zip(got_loader, want_loader):
        assert list(got) == list(want)
        for scope in got:
            _fields_equal(got[scope], want[scope])
        draws += 1
        if draws == 3:
            break
    assert draws == 3


def test_transforms_match_jax():
    rng = np.random.default_rng(5)
    actions = rng.uniform(-1, 1, (11, 7)).astype(np.float32)
    robot_obs = rng.uniform(-3, 3, (11, 15)).astype(np.float32)
    x = rng.normal(size=(4, 9)).astype(np.float32)
    depth = rng.uniform(0.1, 5.0, (2, 6, 6)).astype(np.float32)
    pairs = (
        (transforms.RelativeActions(0.03, 0.07), jax_transforms.RelativeActions(0.03, 0.07), (actions, robot_obs)),
        (transforms.NormalizeVector(x[0], np.abs(x[1])), jax_transforms.NormalizeVector(x[0], np.abs(x[1])), (x,)),
        (transforms.AddGaussianNoise(0.1, 0.02, seed=3), jax_transforms.AddGaussianNoise(0.1, 0.02, seed=3), (x,)),
        (transforms.AddDepthNoise(seed=4), jax_transforms.AddDepthNoise(seed=4), (depth,)),
    )
    for got_t, want_t, args in pairs:
        for _ in range(2):  # the noise transforms' streams advance alike
            got, want = got_t(*args), want_t(*args)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), repr(got_t)
    assert repr(pairs[0][0]) == repr(pairs[0][1])


def test_dataset_statistics_match_jax(root):
    for split in ("training", "validation"):
        got = dataset.DatasetStatistics.load(root / split)
        want = jax_dataset.DatasetStatistics.load(root / split)
        for f in ("robot_obs_mean", "robot_obs_std", "act_min_bound", "act_max_bound", "scene_obs_mean",
                  "scene_obs_std"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_pad_window_and_samplers_match_jax(root):
    rng = np.random.default_rng(6)
    window = {"rel_actions": rng.normal(size=(5, 7)), "robot_obs": rng.normal(size=(5, 15))}
    for n in (3, 5):
        got = dataset.pad_window({k: v[:n] for k, v in window.items()}, 8)
        want = jax_dataset.pad_window({k: v[:n] for k, v in window.items()}, 8)
        assert all(np.array_equal(got[k], want[k]) for k in window)
    store = dataset.EpisodeStore(root / "training", cache="none")
    vis = (dataset.VisionWindowSampler(store.episode_ranges, 6, 8, seed=2),
           jax_dataset.VisionWindowSampler(store.episode_ranges, 6, 8, seed=2))
    lang = (dataset.LangWindowSampler(root / "training", min_window=6, max_window=8, seed=2),
            jax_dataset.LangWindowSampler(root / "training", min_window=6, max_window=8, seed=2))
    for got, want in (vis, lang):
        assert len(got) == len(want)
        assert [astuple(got.sample()) for _ in range(20)] == [astuple(want.sample()) for _ in range(20)]
        assert astuple(got.sample_at(3, deterministic=True)) == astuple(want.sample_at(3, deterministic=True))
    window = store.get_window(5, 4)
    assert all(np.array_equal(window[k], dataset.EpisodeStore(root / "training").get_window(5, 4)[k])
               for k in store.keys)


def test_shm_cache_gives_the_ram_batches(root):
    """The shm arena (the port's own build into build/) against the ram
    cache: the same batches, with one gather thread and with two."""
    lib = shm_store.build()
    assert lib.parent.name == "build" and lib.name.startswith("libhulc_shm-")
    kwargs = dict(batch_size=3, seed=9, fuse=True, **WINDOW)
    ram = make_loaders(PORT_CFG, root, cache="ram", **kwargs)
    shm = make_loaders(PORT_CFG, root, cache="shm", gather_threads=2, **kwargs)
    arena = shm.loaders["vis"].store.shm
    try:
        assert arena is not None and arena.ready and shm.loaders["lang"].store.shm is not None
        for (got, want), _ in zip(zip(shm, ram), range(3)):
            _fields_equal(got["fused"], want["fused"])
        store = shm.loaders["vis"].store
        one = store.gather_padded("rgb_static", [2, 9], [8, 5], 8, n_threads=1)
        np.testing.assert_array_equal(one, ram.loaders["vis"].store.gather_padded("rgb_static", [2, 9], [8, 5], 8))
    finally:
        for loader in shm.loaders.values():
            loader.store.shm.close()
        shm_store.ShmEpisodeCache.unlink(arena.name)


def test_device_loader_on_the_cpu(root):
    loader = make_loaders(PORT_CFG, root, batch_size=2, seed=1, fuse=True, **WINDOW)
    again = make_loaders(PORT_CFG, root, batch_size=2, seed=1, fuse=True, **WINDOW)
    up = DeviceLoader(loader, "cpu")
    assert len(up) == len(loader)
    for (got, want), _ in zip(zip(up, again), range(2)):
        want = batch_to_device(want, "cpu")
        for g, w in zip(got["fused"], want["fused"]):
            assert (g is None) == (w is None)
            if g is not None:
                assert isinstance(g, torch.Tensor) and torch.equal(g, w)
    moved = batch_to_device(want, "cpu")
    assert all(a is b for a, b in zip(moved["fused"], want["fused"]))
