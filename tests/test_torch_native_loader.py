"""The port's C++ prefetching scene loader (native/scene_loader.cpp,
built with g++ here, data/native_loader.py) and Trainer.train over it.

The loader must give read_scene_pack's arrays in any order, with
repeats, with more prefetch than files and after an abandoned epoch; a
missing file, a bad header and an index outside the paths raise, and so
does a source that does not build (no Python fallback). Trainer.train
over the loader must give the list form's history bit for bit on the
CPU, pool eval-in-train gts from the scenes it yielded, and name a
culled scene by its index.
"""

import json

import numpy as np
import pytest
import torch

from detection_3d_tpu_torch.data import native_loader
from detection_3d_tpu_torch.data.native_loader import NativeSceneLoader
from detection_3d_tpu_torch.data.scene_pack import (
    read_scene_pack, write_scene_pack)
from detection_3d_tpu_torch.engine.trainer import Trainer
from test_torch_common import cfg_pair, tiny_scene


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    d = tmp_path_factory.mktemp("packs")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        n = 100 + 17 * i
        write_scene_pack(str(d / f"scene_{i}.spk"), {
            "points": rng.randn(n, 3).astype(np.float32),
            "feats": rng.randn(n, 9).astype(np.float32),
            "gt_boxes": rng.randn(4 + i, 7).astype(np.float32),
            "gt_labels": rng.randint(0, 5, 4 + i).astype(np.int32),
            "flags": rng.rand(4 + i) > 0.5,
            "big": rng.randint(0, 256, 200_000 * (i % 2)).astype(np.uint8),
            "scene_id": np.int64(i)})
        paths.append(str(d / f"scene_{i}.spk"))
    return paths


def _assert_scene_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("order", [None, [5, 4, 3, 2, 1, 0],
                                   [2, 2, 0, 5, 2], [3]])
@pytest.mark.parametrize("n_prefetch,n_threads", [(2, 1), (10, 3)])
def test_loader_equals_read_scene_pack(packs, order, n_prefetch, n_threads):
    loader = NativeSceneLoader(packs, n_prefetch=n_prefetch,
                               n_threads=n_threads)
    assert loader.is_native and len(loader) == 6
    want = list(range(6)) if order is None else order
    for _ in range(2):     # a second epoch on the same handle
        got = list(loader.epoch(order))
        assert [int(s["scene_id"][0]) for s in got] == want
        for s, i in zip(got, want):
            _assert_scene_equal(s, read_scene_pack(packs[i]))
    loader.close()
    assert not loader.is_native


def test_abandoned_epoch_leaves_no_stale_scene(packs):
    loader = NativeSceneLoader(packs, n_prefetch=6, n_threads=3)
    it = loader.epoch([0, 1, 2, 3, 4, 5])
    next(it)
    it.close()                       # five scenes still in flight
    got = [int(s["scene_id"][0]) for s in loader.epoch([5, 3, 1])]
    assert got == [5, 3, 1]
    loader.close()


def test_missing_file_bad_header_and_bad_index_raise(packs, tmp_path):
    bad = tmp_path / "bad.spk"
    bad.write_bytes(b"NOPE" + bytes(8))
    missing = str(tmp_path / "missing.spk")
    loader = NativeSceneLoader([packs[0], str(bad), missing])
    assert int(next(iter(loader.epoch([0])))["scene_id"][0]) == 0
    with pytest.raises(IOError, match="bad header"):
        list(loader.epoch([1]))
    with pytest.raises(IOError, match="open failed"):
        list(loader.epoch([2]))
    with pytest.raises(IndexError):
        list(loader.epoch([3]))
    loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        list(loader.epoch())


@pytest.mark.parametrize("broken", ["missing", "syntax"])
def test_broken_source_raises(tmp_path, monkeypatch, broken, packs):
    """A source that is missing, or that g++ refuses (its output in the
    message), makes the loader raise: no Python fallback."""
    src = tmp_path / "scene_loader.cpp"
    if broken == "syntax":
        src.write_text("void* sl_open( {\n")
    monkeypatch.setattr(native_loader, "SOURCE", src)
    want = {"missing": "unreadable",
            "syntax": "(?s)g\\+\\+ failed.*error"}[broken]
    with pytest.raises(RuntimeError, match=want):
        NativeSceneLoader(packs)


@pytest.fixture(scope="module")
def tiny_packs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    paths = []
    for i in range(2):
        paths.append(str(d / f"tiny_{i}.spk"))
        write_scene_pack(paths[-1], tiny_scene(i))
    return paths


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_train_over_the_loader_equals_the_list(tiny_packs, tmp_path,
                                               scan_steps):
    _, tcfg = cfg_pair()
    runs = []
    for form in ("list", "loader"):
        trainer = Trainer(tcfg, output_dir=str(tmp_path / form),
                          device="cpu")
        trainer.scan_steps = scan_steps
        src = NativeSceneLoader(tiny_packs, n_prefetch=4) \
            if form == "loader" else [tiny_scene(0), tiny_scene(1)]
        state = trainer.train(src, trainer.init_state(seed=0), epochs=2,
                              seed=4)
        runs.append((trainer.history, _params(state), state.solver.count))
    (h_list, p_list, c_list), (h_load, p_load, c_load) = runs
    assert len(h_list) == 4 and c_list == c_load == 4
    assert [h[:3] for h in h_list] == [h[:3] for h in h_load]
    for n, p in p_list.items():
        assert torch.equal(p, p_load[n]), n


def test_eval_in_train_pools_the_loaders_gts(tiny_packs, tmp_path):
    _, tcfg = cfg_pair(eval_in_train=1)
    trainer = Trainer(tcfg, output_dir=str(tmp_path), device="cpu")
    trainer.train(NativeSceneLoader(tiny_packs), trainer.init_state(seed=0),
                  epochs=1)
    labels = np.concatenate([tiny_scene(i)["gt_labels"] for i in range(2)])
    want = np.bincount(labels, minlength=tcfg.num_classes)
    want[0] = 0
    np.testing.assert_array_equal(trainer.last_train_eval.n_gt, want)


def test_a_culled_loader_scene_is_named_by_its_index(tmp_path):
    """Non-finite steps (faked, so only the bookkeeping runs) cull the
    loader's scene 1 under its index."""
    d = tmp_path / "packs"
    d.mkdir()
    paths = []
    for i in range(2):
        scene = dict(tiny_scene(i))
        if i == 1:
            scene["points"] = scene["points"] + 1000.0
        paths.append(str(d / f"s{i}.spk"))
        write_scene_pack(paths[-1], scene)
    _, tcfg = cfg_pair()
    trainer = Trainer(tcfg, output_dir=str(tmp_path), device="cpu")

    def fake_step(st, batch, generator=None, priorities=None):
        is_bad = bool(batch["points"][0, 0] > 500.0)
        st.step += 1
        return (float("nan") if is_bad else 1.0, {}, not is_bad, 100)

    trainer.step = fake_step
    trainer.train(NativeSceneLoader(paths), trainer.init_state(), epochs=5)
    with open(tmp_path / "bad_scenes.json") as f:
        assert json.load(f) == ["1"]
