"""The port's copy of the SUNCG house parser (detection_3d_tpu_torch/data/
house_parser.py) against the JAX package's, on the JAX tests' own
fixtures (tests/test_house_parser.py: a rotated wall's OBJ part, an
L-shaped part, a two-room house.json with its room loader) and on a
2 x 2-room house written in the SUNCG layout on disk
(tests/torch_house_cases.py): OBJ parts, oriented boxes, the camera to
world frames, the house walk, the refinement chain and both point
sources (the z-buffer render and the surface sampler), all equal bit for
bit.
"""

import numpy as np
import pytest

from detection_3d_tpu.data import house_parser as jh
from detection_3d_tpu_torch.data import house_parser as th
from test_house_parser import (
    _two_room_house, box_corners_cam, obj_text_for_boxes,
)
from test_torch_common import assert_same
from torch_house_cases import write_house

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

_SPECS = [("Wall#0", (0, 1, 0), (4, 2, 0.1), 0.0),
          ("Wall#1", (2, 1, 2), (4, 2, 0.1), 1.0),
          ("Ceiling#0", (1, 2.7, 1), (4, 0.1, 3), 0.0)]
_L_SHAPE = np.concatenate([box_corners_cam((0, 0, 0), (2, 1, 2), 0.0),
                           box_corners_cam((1.5, 0, 1.5), (1, 1, 1), 0.0)])

PARTS = {
    "parse_obj_parts": lambda m: m.parse_obj_parts(
        obj_text_for_boxes(_SPECS)),
    "room_obj_boxes": lambda m: m.room_obj_boxes(obj_text_for_boxes(_SPECS)),
    "rotated_wall": lambda m: m.part_oriented_bbox(
        box_corners_cam((2.0, 1.35, -3.0), (4.0, 2.7, 0.1), -0.3), "Wall#0"),
    "l_shape_wall": lambda m: m.part_oriented_bbox(_L_SHAPE, "Wall#1"),
    "l_shape_ceiling": lambda m: m.part_oriented_bbox(_L_SHAPE,
                                                      "Ceiling#1"),
    "frames": lambda m: (m.cam2world_box(np.array([[1.0, 2, 3, 4, 5, 6,
                                                   0.3]])),
                         m.cam2world_points(np.array([[1.0, 2.0, 3.0]])),
                         m.bbox_from_minmax([0, 0, 0], [2, 4, 6])),
}


@pytest.mark.parametrize("case", list(PARTS))
def test_parts_equal(case):
    assert_same(PARTS[case](th), PARTS[case](jh))


@pytest.fixture(scope="module")
def two_rooms():
    house, loader, id2class = _two_room_house()
    raw = jh.parse_house(house, loader, id2class)
    return house, loader, id2class, raw, jh.refine_house_boxes(raw, 1)


def test_two_room_house_walk_and_refine(two_rooms):
    house, loader, id2class, raw, refined = two_rooms
    got = th.parse_house(house, loader, id2class)
    assert_same(got, raw)
    assert_same(th.refine_house_boxes(got, level_num=1), refined)
    assert_same(th.refine_house_boxes(got, level_num=2),
                jh.refine_house_boxes(raw, level_num=2))


@pytest.mark.parametrize("source", ["surface", "render"])
def test_point_sources_equal(two_rooms, source):
    refined = two_rooms[4]
    kw = {"hw": (48, 64), "n_yaw": 6} if source == "render" else {}
    n = 5_000 if source == "surface" else 30_000
    assert_same(th.house_point_cloud(refined, n, method=source, **kw),
                jh.house_point_cloud(refined, n, method=source, **kw))
    with pytest.raises(ValueError):
        th.house_point_cloud(refined, n, method="lidar")


def test_house_file_on_disk_equal(tmp_path):
    """parse_house_file over a 2 x 2-room house in the SUNCG layout:
    walls, ceilings, floors, doors and windows, raw and refined."""
    path, classes = write_house(str(tmp_path), rooms_xy=(2, 2))
    raw = th.parse_house_file(path, classes, refine=False)
    assert {k: v.shape[0] for k, v in raw.items()} == {
        "house": 1, "level": 1, "room": 4, "wall": 64, "ceiling": 4,
        "floor": 4, "door": 4, "window": 4}
    assert_same(raw, jh.parse_house_file(path, classes, refine=False))
    refined = th.parse_house_file(path, classes)
    assert_same(refined, jh.parse_house_file(path, classes))
    assert refined["wall"].shape[0] < 64
