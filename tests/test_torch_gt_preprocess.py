"""The port's copy of the ground-truth refinement
(detection_3d_tpu_torch/data/gt_preprocess.py) against the JAX
package's, on the JAX tests' own fixtures (tests/test_gt_preprocess.py)
and on the wall layout of a 2 x 2-room house (tests/torch_house_cases.py).

Outputs must be equal: the copy is the same numpy, and its two calls
that moved from jnp to torch (the wall-pair IoU of
merge_2pieces_of_1wall, ops/rotated_iou.rotated_iou_pair, and the wall
corners of make_ceiling_floor, ops/geometry.box3d_corners, both float32
as in JAX) feed thresholds and extents that come out the same on these
layouts, so every output is held bit for bit.
"""

import numpy as np
import pytest

from detection_3d_tpu.data import gt_preprocess as jg
from detection_3d_tpu_torch.data import gt_preprocess as tg
from test_gt_preprocess import _rect_walls, wall
from test_torch_common import assert_same
from torch_house_cases import room_boxes

# the copied numpy takes 2-D np.cross, which NumPy 2 deprecates
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _house_walls(nx=2, ny=2, room=8.0):
    out = []
    for ry in range(ny):
        for rx in range(nx):
            b = room_boxes(room)["w"].copy()
            b[:, :3] += [(rx + 0.5) * room, (ry + 0.5) * room, 0.0]
            out.append(b)
    return np.concatenate(out)


def _rotated_room(g=0.3):
    c, s = np.cos(g), np.sin(g)
    out = []
    for w in _rect_walls(0, 0, 5, 4):
        w = w.copy()
        w[0], w[1] = c * w[0] + s * w[1], -s * w[0] + c * w[1]
        w[6] = (w[6] + g) % np.pi
        out.append(w)
    return np.stack(out)


WALLS = {
    "t_junction": lambda: np.stack([wall(0, 0, 6.0),
                                    wall(0, 1.5, 3.0, yaw=np.pi / 2)]),
    "near_duplicate": lambda: np.stack([wall(0, 0, 4.0),
                                        wall(0.01, 0.005, 4.0)]),
    "pipeline": lambda: np.stack([wall(1.0, 0, 2.0), wall(3.5, 0, 3.0),
                                  wall(3.51, 0.004, 3.0),
                                  wall(0, 2, 4.0, yaw=np.pi / 2)]),
    "one_room": lambda: np.stack([wall(0, -2, 4.0), wall(0, 2, 4.0),
                                  wall(-2, 0, 4.0, yaw=np.pi / 2),
                                  wall(2, 0, 4.0, yaw=np.pi / 2)]),
    "two_rooms": lambda: np.stack(_rect_walls(0, 0, 4, 3)
                                  + _rect_walls(4, 0, 9, 3)),
    "l_shape": lambda: np.stack([wall(4, 0, 8.0),
                                 wall(8, 2, 4.0, yaw=np.pi / 2),
                                 wall(6, 4, 4.0),
                                 wall(4, 6, 4.0, yaw=np.pi / 2),
                                 wall(2, 8, 4.0),
                                 wall(0, 4, 8.0, yaw=np.pi / 2)]),
    "rotated": _rotated_room,
    "house_2x2": _house_walls,
}

FNS = {
    "define_walls_direction": lambda m, w: m.define_walls_direction(w),
    "crop_walls": lambda m, w: m.crop_walls(m.define_walls_direction(w)),
    "find_close_walls": lambda m, w: m.find_close_walls(
        m.define_walls_direction(w)),
    "preprocess_walls": lambda m, w: m.preprocess_walls(w),
    "rooms_from_walls": lambda m, w: m.rooms_from_walls(w),
    "make_ceiling_floor": lambda m, w: m.make_ceiling_floor(w),
    "preprocess_cfr": lambda m, w: m.preprocess_cfr(
        m.make_ceiling_floor(w)[0], w),
}


@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("walls", list(WALLS))
def test_wall_chain_equal(walls, fn):
    w = WALLS[walls]()
    assert_same(FNS[fn](tg, w.copy()), FNS[fn](jg, w.copy()))


MERGES = {
    "colinear_x": (wall(1.0, 0, 2.0), wall(3.5, 0, 3.0), "X"),
    "perpendicular": (wall(0, 0, 2.0), wall(0, 1, 2.0, yaw=np.pi / 2), "X"),
    "gap": (wall(0, 0, 2.0), wall(5.0, 0, 2.0), "X"),
    "double_drywall": (wall(0, 0.05, 4.0), wall(0, -0.05, 4.0), "Y"),
    "overlap_y": (wall(0, 0.02, 4.0), wall(0.3, -0.03, 3.0), "Y"),
}


@pytest.mark.parametrize("case", list(MERGES))
def test_merge_2pieces_equal(case):
    b0, b1, dim = MERGES[case]
    assert_same(tg.merge_2pieces_of_1wall(b0, b1, dim),
                jg.merge_2pieces_of_1wall(b0, b1, dim))


def test_cenline_intersection_equal():
    a, b = wall(0, 0, 6.0), wall(0, 1.5, 3.0, yaw=np.pi / 2)
    for x, y in ((a, b), (b, a)):
        got, want = tg.cenline_intersection_2d(x, y), \
            jg.cenline_intersection_2d(x, y)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_openings_equal():
    """The JAX fixture's badly rotated window, and the 2 x 2 house's doors
    and windows against its refined walls."""
    walls = np.stack([wall(0, 0, 6.0, t=0.2)])
    win = np.array([[1.0, 0.0, 1.5, 1.0, 0.9, 1.2, 0.4]])
    assert_same(tg.preprocess_openings(win, walls),
                jg.preprocess_openings(win, walls))
    refined = jg.preprocess_walls(_house_walls())
    for kind, fn in (("door", "preprocess_doors"),
                     ("window", "preprocess_windows")):
        boxes = np.concatenate([
            room_boxes()[kind] + [(rx + 0.5) * 8, (ry + 0.5) * 8, 0, 0, 0,
                                  0, 0]
            for ry in range(2) for rx in range(2)])
        assert_same(getattr(tg, fn)(boxes, refined),
                    getattr(jg, fn)(boxes, refined))
