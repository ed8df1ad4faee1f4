"""Kernel C's module (ops/rotated_iou.py, ops/nms.py) and the box
geometry it rests on: the port's plain IoU against JAX's XLA path for
criteria -1/0/1/2 within atol 1e-5 (float rounding of cos/sin and the
centroid sums), and NMS keep sets identical.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops import box_coder as jcoder
from detection_3d_tpu.ops import geometry as jgeo
from detection_3d_tpu.ops.nms import nms_boxes as j_nms
from detection_3d_tpu.ops.rotated_iou import (
    boxes_iou_3d as j_iou3d, rotated_iou_matrix as j_iou,
)
from detection_3d_tpu_torch.ops import box_coder as tcoder
from detection_3d_tpu_torch.ops import geometry as tgeo
from detection_3d_tpu_torch.ops.nms import nms_boxes
from detection_3d_tpu_torch.ops.rotated_iou import (
    boxes_iou_3d, rotated_iou_matrix, rotated_iou_plain,
)


def _random_bev(rng, n, spread=3.0):
    return np.c_[rng.uniform(-spread, spread, (n, 2)),
                 rng.uniform(0.1, 2.5, (n, 2)),
                 rng.uniform(-1.6, 1.6, (n, 1))].astype(np.float32)


def _special_bev():
    """Identical, touching (shared edge and shared corner), nested, thin,
    axis-aligned and rotated copies of the same rectangle."""
    return np.array([
        [0, 0, 2, 1, 0], [0, 0, 2, 1, 0],          # identical
        [2, 0, 2, 1, 0],                           # shares an edge
        [2, 1, 2, 1, 0],                           # shares a corner
        [0, 0, 1, 0.5, 0],                         # nested
        [0, 0, 4, 0.095, 0.3],                     # thin wall
        [0, 0, 2, 1, np.pi / 2], [0, 0, 1, 2, 0],  # same box, turned
        [0.5, 0.25, 1, 0.5, 0.785],
        [5, 5, 1, 1, -1.0],                        # disjoint
    ], np.float32)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
@pytest.mark.parametrize("case", ["random", "special"])
def test_plain_iou_matches_xla(criterion, case):
    if case == "random":
        rng = np.random.RandomState(criterion + 2)
        boxes, query = _random_bev(rng, 37), _random_bev(rng, 53)
    else:
        boxes = query = _special_bev()
    want = np.asarray(j_iou(jnp.asarray(boxes), jnp.asarray(query),
                            criterion=criterion, same_box_fix=False,
                            impl="xla"))
    got = rotated_iou_plain(torch.from_numpy(boxes), torch.from_numpy(query),
                            criterion).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # same_box_fix applies outside the kernel in both packages
    want_fix = np.asarray(j_iou(jnp.asarray(boxes), jnp.asarray(query),
                                criterion=criterion, impl="xla"))
    got_fix = rotated_iou_matrix(torch.from_numpy(boxes),
                                 torch.from_numpy(query), criterion).numpy()
    np.testing.assert_allclose(got_fix, want_fix, atol=1e-5, rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("criterion", [-1, 2])
def test_plain_iou_matches_pallas_interpret(criterion):
    from detection_3d_tpu.ops.pallas.rotated_iou_kernel import (
        rotated_iou_matrix_pallas,
    )
    rng = np.random.RandomState(0)
    boxes, query = _random_bev(rng, 13), _random_bev(rng, 37)
    want = np.asarray(rotated_iou_matrix_pallas(
        jnp.asarray(boxes), jnp.asarray(query), criterion=criterion,
        interpret=True))
    got = rotated_iou_plain(torch.from_numpy(boxes), torch.from_numpy(query),
                            criterion).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _random_boxes7(rng, n):
    """yx_zb boxes clustered so that many pairs overlap."""
    c = rng.uniform(0, 4, (n, 2))
    return np.c_[c, rng.uniform(0, 1, (n, 1)), rng.uniform(0.1, 1.5, (n, 2)),
                 rng.uniform(0.2, 2.0, (n, 1)),
                 rng.uniform(-1.5, 1.5, (n, 1))].astype(np.float32)


def test_boxes_iou_3d_matches_jax():
    rng = np.random.RandomState(5)
    t, a = _random_boxes7(rng, 40), _random_boxes7(rng, 30)
    aug = {"target_Y": 0.4, "anchor_Y": 0.1, "target_Z": 0.8,
           "anchor_Z": 0.0}
    for kw in ({}, {"aug_thickness": aug, "criterion": 2},
               {"only_xy": True}):
        want = np.asarray(j_iou3d(jnp.asarray(t), jnp.asarray(a), **kw))
        got = boxes_iou_3d(torch.from_numpy(t), torch.from_numpy(a),
                           **kw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keep_sets_identical(seed):
    rng = np.random.RandomState(seed)
    n = 200
    boxes = _random_boxes7(rng, n)
    boxes[10:20] = boxes[0]                    # exact duplicates
    scores = rng.rand(n).astype(np.float32)
    scores[30:40] = scores[30]                 # score ties
    valid = rng.rand(n) > 0.1
    jk, jc = j_nms(jnp.asarray(boxes), jnp.asarray(scores),
                   jnp.asarray(valid), 0.3, 64)
    tk, tc = nms_boxes(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), 0.3, 64)
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_geometry_and_decode_match_jax():
    rng = np.random.RandomState(3)
    boxes = _random_boxes7(rng, 50)
    boxes[:, 6] = rng.uniform(-4, 4, 50)
    for name in ("yx_zb_to_standard", "standard_to_yx_zb"):
        want = np.asarray(getattr(jgeo, name)(jnp.asarray(boxes)))
        got = getattr(tgeo, name)(torch.from_numpy(boxes)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    want = np.asarray(jgeo.rbbox_corners_2d(jnp.asarray(boxes[:, :5])))
    got = tgeo.rbbox_corners_2d(torch.from_numpy(boxes[:, :5])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    enc = (rng.randn(50, 21) * 0.3).astype(np.float32)
    w = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 0.5)
    want = np.asarray(jcoder.BoxCoder3D(weights=w).decode(
        jnp.asarray(enc), jnp.asarray(boxes)))
    got = tcoder.BoxCoder3D(weights=w).decode(
        torch.from_numpy(enc), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    tgt = _random_boxes7(rng, 50)
    want = np.asarray(jcoder.BoxCoder3D().encode(jnp.asarray(tgt),
                                                 jnp.asarray(boxes)))
    got = tcoder.BoxCoder3D().encode(torch.from_numpy(tgt),
                                     torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
