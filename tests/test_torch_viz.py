"""The port's copy of the visualisation toolbox (detection_3d_tpu_torch/
utils/viz.py) against the JAX package's (utils/viz.py): the box corner
loops equal, the three panels written as PNGs (matplotlib is installed
here), and no matplotlib import until a panel is drawn (the card machine
has none)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from detection_3d_tpu.utils import viz as jviz
from detection_3d_tpu_torch.utils import viz as tviz
from test_viz import _boxes


@pytest.mark.parametrize("fn", ["_corners2d", "_corners3d"])
def test_corners_equal_jax(fn):
    boxes = np.r_[_boxes(), np.random.RandomState(0).rand(5, 7)]
    np.testing.assert_array_equal(getattr(tviz, fn)(boxes),
                                  getattr(jviz, fn)(boxes))


def test_panels_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    pts = np.random.RandomState(0).rand(2000, 3) * [5, 5, 3]
    boxes, labels = _boxes(), np.array([1, 1, 4])
    paths = [
        tviz.draw_points_bboxes(pts, boxes, labels,
                                path=str(tmp_path / "bev.png"),
                                class_names=("bg", "wall", "door", "window",
                                             "ceiling", "floor"),
                                gt_boxes=boxes, gt_labels=labels,
                                title="t"),
        tviz.draw_scene_3d(pts, boxes, labels,
                           path=str(tmp_path / "scene3d.png")),
        tviz.draw_eval_matches(boxes, labels, boxes, labels,
                               np.array([0.9, 0.8, 0.7]),
                               matched=np.array([True, False, True]),
                               points=pts, path=str(tmp_path / "m.png")),
        tviz.draw_points_bboxes(None, np.zeros((0, 7)),
                                path=str(tmp_path / "empty.png"))]
    for p in paths:
        assert os.path.getsize(p) > 1_000


def test_import_does_not_load_matplotlib():
    code = ("import sys, detection_3d_tpu_torch.utils.viz; "
            "sys.exit('matplotlib' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert subprocess.run([sys.executable, "-c", code], cwd=root,
                          timeout=120).returncode == 0
