"""The port's copies of the JAX package's numpy data tools, byte for byte:
``synthetic_varied_building`` (data/synthetic.py), ``augment_scene``
and ``elastic_distortion`` (data/augment.py) and ``split_scene``
(data/scene_packing.py). The same seed (or the same RandomState) must
give arrays of the same dtype, shape and bytes in both packages.
"""

import numpy as np
import pytest

from detection_3d_tpu.data import augment as jaug
from detection_3d_tpu.data import scene_packing as jpack
from detection_3d_tpu.data import synthetic as jsyn
from detection_3d_tpu_torch.data import augment as taug
from detection_3d_tpu_torch.data import scene_packing as tpack
from detection_3d_tpu_torch.data import synthetic as tsyn


def assert_scenes_identical(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_synthetic_varied_building_byte_equal(seed):
    a = jsyn.synthetic_varied_building(seed=seed, num_points=8000)
    b = tsyn.synthetic_varied_building(seed=seed, num_points=8000)
    assert_scenes_identical(a, b)
    assert b["n_rooms"] >= 2


def test_synthetic_varied_building_options_byte_equal():
    kw = dict(seed=7, num_points=5000, voxel_scale=50, max_cells=4)
    assert_scenes_identical(jsyn.synthetic_varied_building(**kw),
                            tsyn.synthetic_varied_building(**kw))


@pytest.mark.parametrize("flags", [
    {},
    {"zoom_rate": 0.1, "flip_x": True, "rotate": True, "norm_noise": 0.05},
    {"elastic": True, "rotate": True, "voxel_scale": 25},
])
def test_augment_scene_byte_equal(flags):
    scene = tsyn.synthetic_building(seed=2, num_points=3000, voxel_scale=25)
    a = jaug.augment_scene(scene, np.random.RandomState(11), **flags)
    b = taug.augment_scene(scene, np.random.RandomState(11), **flags)
    assert_scenes_identical(a, b)
    # the input is left as it was
    assert_scenes_identical(scene, tsyn.synthetic_building(
        seed=2, num_points=3000, voxel_scale=25))


def test_elastic_distortion_byte_equal():
    pts = np.random.RandomState(0).uniform(0, 200, (2000, 3)).astype(
        np.float32)
    a = jaug.elastic_distortion(pts, 6, 40.0, np.random.RandomState(3))
    b = taug.elastic_distortion(pts, 6, 40.0, np.random.RandomState(3))
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", ["split", "subsample", "whole"])
def test_split_scene_byte_equal(case):
    scene = tsyn.synthetic_multiroom(seed=1, num_points=20_000,
                                     rooms_xy=(3, 2), room=8.0,
                                     voxel_scale=1)
    kw = {"split": dict(max_size_m=10.0, min_points=100),
          "subsample": dict(max_size_m=12.0, max_points=2000,
                            min_points=100),
          "whole": dict()}[case]
    a = jpack.split_scene(scene, rng=np.random.RandomState(4), **kw)
    b = tpack.split_scene(scene, rng=np.random.RandomState(4), **kw)
    assert len(a) == len(b) >= 1
    if case == "whole":
        assert len(b) == 1 and b[0] is scene
    else:
        assert len(b) > 1
    for x, y in zip(a, b):
        assert_scenes_identical(x, y)
    if case == "subsample":
        assert all(y["points"].shape[0] <= 2000 for y in b)
