"""The port's SUNCG dataset (data/suncg.py) against the JAX package's, on
reference-format house files that the test writes.

A house holds ``(pcl (N, 9) xyz-colour-normal in metres, {class: (M, 7)
standard boxes})``; the cases include a ceiling at standard yaw pi/2
and a floor at yaw 0 (after the conversion, the floor sits at an odd
quarter turn and swaps its sizes; both yaws are zeroed), a class the
config does not select, an empty class, and points outside the grid
(dropped). Both
datasets must give equal scenes, bit for bit, and agree on the scene
lists (split file, ``cfg.scenes``, ``bad_scenes.json``).
"""

import json

import numpy as np
import pytest
import torch

from detection_3d_tpu.data import suncg as jsuncg
from detection_3d_tpu_torch.data import suncg as tsuncg
from test_torch_common import cfg_pair


def _house(seed):
    """A tiny house in metres: 2000 points with features, and boxes of
    every class kind (tiny config grid: 12.8 x 12.8 x 3.2 m at scale 20)."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform([-3, -4, 0], [5, 4, 2.8], (2000, 3))
    xyz[:3] = [[30.0, 0, 1], [0, 0, 9.0], [4, 20.0, 1]]   # off the grid
    pcl = np.c_[xyz, rng.rand(2000, 3), rng.randn(2000, 3)].astype(
        np.float32)
    wall = np.c_[rng.uniform(-3, 3, (4, 2)), np.full(4, 1.35),
                 rng.uniform(1, 4, 4), np.full(4, 0.1), np.full(4, 2.7),
                 rng.uniform(0, np.pi, 4)]
    boxes = {
        "wall": wall.astype(np.float32),
        "door": np.array([[1, -4, 1, 0.9, 0.15, 2, 0.3]], np.float32),
        "window": np.zeros((0, 7), np.float32),
        "ceiling": np.array([[0.5, 0, 2.74, 8, 6, 0.12, np.pi / 2]],
                            np.float32),
        "floor": np.array([[0.5, 0, 0.06, 8, 6, 0.12, 0.0]], np.float32),
    }
    return pcl, boxes


def _cfg(classes):
    jc, tc = cfg_pair()
    return jc.replace(classes=classes), tc.replace(classes=classes)


CLASSES = {"four": ("background", "wall", "door", "window"),
           "six": ("background", "wall", "door", "window", "ceiling",
                   "floor")}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("suncg")
    for i, scene in enumerate(["house_a", "house_b", "house_c"]):
        d = root / "houses" / scene
        d.mkdir(parents=True)
        for j in range(2 if scene == "house_a" else 1):
            torch.save(_house(10 * i + j), d / f"{j}.pth")
    split = root / "train_test_splited"
    split.mkdir()
    (split / "train.txt").write_text("house_a\nhouse_b\n\nhouse_c\n")
    (split / "test.txt").write_text("house_c\n")
    (root / "bad_scenes.json").write_text(json.dumps(["house_b"]))
    return root


def _assert_scenes_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("classes", sorted(CLASSES))
@pytest.mark.parametrize("split", ["train", "test"])
def test_scenes_equal(data_root, classes, split):
    jc, tc = _cfg(CLASSES[classes])
    jds = jsuncg.SUNCGDataset(split, jc, str(data_root))
    tds = tsuncg.SUNCGDataset(split, tc, str(data_root))
    assert tds.files == jds.files and len(tds) == len(jds) > 0
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        _assert_scenes_equal(got, want)
        assert got["points"].shape[0] == 1997      # 3 points off the grid
        _assert_scenes_equal(tds.get_groundtruth(i), jds.get_groundtruth(i))


def test_ceiling_at_quarter_turn_is_zeroed(data_root):
    _, tc = _cfg(CLASSES["six"])
    ds = tsuncg.SUNCGDataset("test", tc, str(data_root))
    s = ds[0]
    label = tc.dataset_metas().class_2_label
    ceiling = s["gt_boxes"][s["gt_labels"] == label["ceiling"]]
    floor = s["gt_boxes"][s["gt_labels"] == label["floor"]]
    assert ceiling.shape[0] == floor.shape[0] == 1
    assert ceiling[0, 6] == 0.0 and floor[0, 6] == 0.0
    # the same standard sizes a quarter turn apart: swapped footprints
    np.testing.assert_array_equal(ceiling[0, 3:5], floor[0, 3:5][::-1])


def test_cfg_scenes_override_the_split_file(data_root):
    jc, tc = _cfg(CLASSES["four"])
    jc, tc = (c.replace(scenes=("house_c", "house_a")) for c in (jc, tc))
    jds = jsuncg.SUNCGDataset("train", jc, str(data_root))
    tds = tsuncg.SUNCGDataset("train", tc, str(data_root))
    assert tds.files == jds.files and len(tds.files) == 3


def test_empty_root_reads_the_environment(data_root, monkeypatch):
    _, tc = _cfg(CLASSES["four"])
    monkeypatch.setenv("SUNCG_TORCH_PATH", str(data_root))
    assert len(tsuncg.SUNCGDataset("test", tc)) == 1
    monkeypatch.setenv("SUNCG_TORCH_PATH", "")
    assert len(tsuncg.SUNCGDataset("test", tc)) == 0


@pytest.mark.parametrize("bad", [None, [], ["b"], ["a", "c", "zz"]])
def test_rm_bad_samples_agrees(tmp_path, bad):
    names = ["a", "b", "c", "b"]
    path = None
    if bad is not None:
        path = str(tmp_path / "bad.json")
        with open(path, "w") as f:
            json.dump(bad, f)
    assert tsuncg.rm_bad_samples(names, path) == \
        jsuncg.rm_bad_samples(names, path)


@pytest.mark.parametrize("yaw", [0.0, np.pi / 2, -np.pi / 2, np.pi, 1.4,
                                 3 * np.pi / 2])
def test_set_yaw_zero_agrees(yaw):
    b = np.array([[1, 2, 0, 2.0, 4.0, 1.0, yaw]], np.float32)
    np.testing.assert_array_equal(tsuncg._set_yaw_zero(b),
                                  jsuncg._set_yaw_zero(b))
    empty = np.zeros((0, 7), np.float32)
    assert tsuncg._set_yaw_zero(empty).shape == (0, 7)


def test_prepare_scene_without_xyz_features():
    jc, tc = _cfg(CLASSES["four"])
    jc, tc = (c.replace(elements=("color", "normal")) for c in (jc, tc))
    pcl, boxes = _house(3)
    want = jsuncg.SUNCGDataset("train", jc, "").prepare_scene(pcl, boxes)
    got = tsuncg.SUNCGDataset("train", tc, "").prepare_scene(pcl, boxes)
    _assert_scenes_equal(got, want)
    assert got["feats"].shape[1] == 6
