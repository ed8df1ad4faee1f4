"""The port's copy of the depth renderer (detection_3d_tpu_torch/data/
depth_render.py, a numpy z-buffer) against the JAX package's, on the JAX
tests' own fixtures (tests/test_depth_render.py): cameras, triangles,
depth images, back-projection, the voxel downsample and a whole room's
rendered cloud, all equal bit for bit; and its triangles against the
port's ops/geometry.box3d_corners (one rotation convention).
"""

import numpy as np
import pytest
import torch

from detection_3d_tpu.data import depth_render as jd
from detection_3d_tpu_torch.data import depth_render as td
from detection_3d_tpu_torch.ops.geometry import box3d_corners
from test_depth_render import _flat_wall
from test_torch_common import assert_same


def _room():
    walls = np.stack([_flat_wall(2.0, 0.0), _flat_wall(2.0, 4.0),
                      _flat_wall(0.0, 2.0, yaw=np.pi / 2),
                      _flat_wall(4.0, 2.0, yaw=np.pi / 2)])
    return {"wall": walls,
            "floor": np.array([[2.0, 2.0, -0.05, 4.2, 4.2, 0.1, 0.0]]),
            "ceiling": np.array([[2.0, 2.0, 2.75, 4.2, 4.2, 0.1, 0.0]])}


CASES = {
    "make_camera": lambda m: m.make_camera([3.0, 2.0, 1.5], [1.0, 0.2, -0.1],
                                           [0, 0, 1.0]),
    "cam_extrinsics": lambda m: m.cam_extrinsics(m.make_camera(
        [3.0, 2.0, 1.5], [1.0, 0.2, -0.1], [0, 0, 1.0])),
    "cam_focus": lambda m: m.cam_focus(m.make_camera(
        [0.0, 0.0, 1.4], [1.0, 0.25, 0.0], [0, 0, 1.0]), (96, 128)),
    "cameras_for_rooms": lambda m: m.cameras_for_rooms(
        np.array([[2.0, 3.0, 0.0, 5.0, 4.0, 0.2, 0.4]]), n_yaw=8,
        hw=(60, 80)),
    "boxes_to_triangles": lambda m: m.boxes_to_triangles(
        np.array([[1.0, 2.0, 1.5, 3.0, 0.4, 2.0, 0.7]])),
    "render_depth_occluded": lambda m: m.render_depth(
        m.boxes_to_triangles(np.stack([
            _flat_wall(3.0, 0.0, cz=1.5, sx=0.1, sy=8.0, sz=6.0),
            _flat_wall(7.0, 0.0, cz=1.5, sx=0.1, sy=8.0, sz=6.0)])),
        m.make_camera([0.0, 0.0, 1.5], [1.0, 0.0, 0.0], [0, 0, 1.0]),
        hw=(60, 80)),
    "depth_to_pcl": lambda m: m.depth_to_pcl(*(lambda box, cam: (
        m.render_depth(m.boxes_to_triangles(box[None]), cam, hw=(96, 128)),
        cam))(np.array([4.0, 1.0, 1.5, 2.0, 3.0, 3.0, 0.3]),
              m.make_camera([0.0, 0.0, 1.4], [1.0, 0.25, 0.0],
                            [0, 0, 1.0]))),
    "voxel_downsample": lambda m: m.voxel_downsample(
        np.random.RandomState(0).rand(5000, 3).astype(np.float32),
        voxel=0.1),
    "render_house_pcl": lambda m: m.render_house_pcl(_room(), hw=(48, 64),
                                                     n_yaw=6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_equal_to_jax(case):
    assert_same(CASES[case](td), CASES[case](jd))


def test_triangles_use_the_corners_convention():
    box = np.array([[1.0, 2.0, 1.5, 3.0, 0.4, 2.0, 0.7]])
    verts = td.boxes_to_triangles(box).reshape(-1, 3)
    ref = box3d_corners(torch.from_numpy(box)).numpy().reshape(-1, 3)
    d = np.linalg.norm(verts[:, None] - ref[None], axis=-1).min(1)
    assert d.max() < 1e-6
