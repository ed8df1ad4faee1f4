"""Kernel C's module (ops/rotated_iou.py, ops/nms.py) and the box
geometry it rests on: the port's plain IoU against JAX's XLA path for
criteria -1/0/1/2 within atol 1e-5 (float rounding of cos/sin and the
centroid sums), and NMS keep sets identical. A batch of matrices (the
NMS of a unit's buildings and classes) against per-matrix calls: the
plain IoU bit for bit, the greedy pass (kernel E's plain version) keep
set for keep set and against JAX's fori_loop, on float32 IoU matrices
with entries at the float32 threshold, beside it and NaN; boxes_iou_3d
without thickness floors clamps negative sizes at 0 as JAX does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops import box_coder as jcoder
from detection_3d_tpu.ops import geometry as jgeo
from detection_3d_tpu.ops.nms import _greedy_suppress as j_greedy
from detection_3d_tpu.ops.nms import nms_boxes as j_nms
from detection_3d_tpu.ops.rotated_iou import (
    boxes_iou_3d as j_iou3d, rotated_iou_matrix as j_iou,
)
from detection_3d_tpu_torch.ops import box_coder as tcoder
from detection_3d_tpu_torch.ops import geometry as tgeo
from detection_3d_tpu_torch.ops.nms import greedy_plain, nms_boxes
from detection_3d_tpu_torch.ops.rotated_iou import (
    boxes_iou_3d, rotated_iou_matrix, rotated_iou_pairs, rotated_iou_plain,
)
from torch_iou_cases import adversarial_bev


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


@pytest.mark.parametrize("criterion", [-1, 2])
def test_batched_plain_iou_bit_equal_per_matrix(criterion):
    # the adversarial boxes as targets, a slice of them reversed as
    # queries, two matrices
    mats = [torch.from_numpy(adversarial_bev(seed)[160:]) for seed in (0, 1)]
    boxes = torch.stack(mats)
    query = torch.stack([m.flip(0)[::3] for m in mats])
    for fix in (False, True):
        got = rotated_iou_plain(boxes, query, criterion, fix)
        pairs = rotated_iou_pairs(boxes, query, criterion, fix)
        for g in range(boxes.shape[0]):
            want = rotated_iou_plain(boxes[g], query[g], criterion, fix)
            for a in (got[g], pairs[g]):
                assert torch.equal(torch.nan_to_num(a, nan=7.0),
                                   torch.nan_to_num(want, nan=7.0))


def _overlap_cases(n, g, seed):
    """(G, N, N) IoU matrices with ties and a matrix whose rows are all
    invalid, and their validity."""
    rng = np.random.RandomState(seed)
    iou = rng.rand(g, n, n).astype(np.float32)
    iou[:, :, :8] = 0.5                          # exactly at the threshold
    iou[1, 3] = iou[1, 5]                        # two equal rows
    valid = rng.rand(g, n) > 0.2
    valid[2] = False                             # all invalid
    return iou, valid


@pytest.mark.parametrize("n,post", [(300, 64), (97, 200)])
def test_batched_greedy_keep_sets_identical(n, post):
    iou, valid = _overlap_cases(n, 4, seed=n)
    iou_t = torch.from_numpy(iou)
    keep, count = greedy_plain(iou_t, torch.from_numpy(valid), 0.5, post)
    assert keep.shape == (4, post) and count.shape == (4,)
    assert int(count[2]) == 0 and bool((keep[2] == -1).all())
    for g in range(4):
        k1, c1 = greedy_plain(iou_t[g:g + 1],
                              torch.from_numpy(valid[g:g + 1]), 0.5, post)
        assert torch.equal(keep[g], k1[0]) and int(count[g]) == int(c1[0])
        jk, jc = j_greedy(jnp.asarray(iou[g]), jnp.asarray(valid[g]), 0.5,
                          post)
        np.testing.assert_array_equal(keep[g].numpy(), np.asarray(jk))
        assert int(count[g]) == int(jc)


def _threshold_edge_cases(n, t, seed):
    """(3, N, N) float32 IoU matrices whose entries sit on float32(t) and
    its neighbours on both sides, with NaNs among them; the last matrix
    all invalid."""
    rng = np.random.RandomState(seed)
    t32 = np.float32(t)
    edges = np.array([t32, np.nextafter(t32, np.float32(2)),
                      np.nextafter(t32, np.float32(-1)), np.nan, 0.0, 1.0],
                     np.float32)
    iou = rng.rand(3, n, n).astype(np.float32)
    pick = rng.rand(3, n, n) < 0.6
    iou[pick] = edges[rng.randint(0, edges.size, int(pick.sum()))]
    valid = rng.rand(3, n) > 0.15
    valid[2] = False
    return iou, valid


@pytest.mark.parametrize("post", ["below", "above"])
@pytest.mark.parametrize("n", [37, 64, 65, 129])
@pytest.mark.parametrize("t", [0.5, 0.7, 0.1])
def test_greedy_threshold_edges_match_jax(t, n, post):
    """Kernel E's contract on the CPU: greedy_plain compares the float32
    IoU with float32(t), as JAX's _greedy_suppress does (0.7 and 0.1 are
    not exact in float32; entries at float32(t) do not suppress, its
    upper neighbour does, NaN never does), across the 64-bit word
    boundaries of kernel E's masks; post below and above the kept
    count; keep sets identical to JAX's."""
    iou, valid = _threshold_edge_cases(n, t, seed=n + int(t * 10))
    iou_t, valid_t = torch.from_numpy(iou), torch.from_numpy(valid)
    _, full_count = greedy_plain(iou_t, valid_t, t, n)
    cap = (max(1, int(full_count[:2].min()) - 3) if post == "below"
           else n + 7)
    keep, count = greedy_plain(iou_t, valid_t, t, cap)
    assert int(count[2]) == 0 and bool((keep[2] == -1).all())
    if post == "below":
        assert bool((full_count[:2] > cap).all())
        assert bool((count[:2] == cap).all())
    for g in range(3):
        jk, jc = j_greedy(jnp.asarray(iou[g]), jnp.asarray(valid[g]), t, cap)
        np.testing.assert_array_equal(keep[g].numpy(), np.asarray(jk))
        assert int(count[g]) == int(jc)


@pytest.mark.parametrize("t", [0.1, 0.7])
def test_greedy_compares_in_float32(t):
    """An entry equal to float32(t) exceeds t in float64 (0.1, 0.7 round
    up) or not, yet never suppresses: the pass compares in float32."""
    t32 = np.float32(t)
    iou = np.zeros((1, 3, 3), np.float32)
    iou[0, 0, 1] = t32
    iou[0, 0, 2] = np.nextafter(t32, np.float32(2))
    valid = np.ones((1, 3), bool)
    keep, count = greedy_plain(torch.from_numpy(iou), torch.from_numpy(valid),
                               t, 3)
    jk, _ = j_greedy(jnp.asarray(iou[0]), jnp.asarray(valid[0]), t, 3)
    assert keep[0].tolist() == [0, 1, -1] == np.asarray(jk).tolist()
    assert int(count[0]) == 2


def test_boxes_iou_3d_clamps_negative_sizes_as_jax():
    rng = np.random.RandomState(8)
    t, a = _random_boxes7(rng, 30), _random_boxes7(rng, 20)
    t[::3, 3] *= -1          # negative y sizes
    a[1::4, 5] *= -1         # negative z sizes
    t[2::5, 5] = -0.3
    want = np.asarray(j_iou3d(jnp.asarray(t), jnp.asarray(a)))
    got = boxes_iou_3d(torch.from_numpy(t), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # G = 2 of them at once, each matrix its own call's bits
    both = boxes_iou_3d(torch.from_numpy(np.stack([t, t[::-1].copy()])),
                        torch.from_numpy(np.stack([a, a])))
    assert torch.equal(both[0], torch.from_numpy(got))
