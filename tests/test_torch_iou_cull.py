"""Kernel C's cull and same-box fix (ops/rotated_iou.py), on the CPU.

``iou_may_meet`` is the plain form of the kernel's cull: a pair it rules
out must have a plain intersection of exactly +0, so that the kernel,
which writes the criterion's formula at inter = +0 for it, gives the
plain version's bits. It must never rule out a pair that meets, on any
box family, and it must rule out most pairs of a spread layout. The
same-box fix now lives inside ``rotated_iou_plain`` (and the kernel):
it must equal the JAX package's ``rotated_iou_matrix(same_box_fix=True)``
within 1e-6 where it fires and leave ``rotated_iou_matrix``'s results as
they were. ``rotated_iou_pairs``, the CPU route of
``rotated_iou_matrix``, computes the intersection only where
``iou_may_meet`` holds and must give ``rotated_iou_plain``'s bits on
every pair.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops.rotated_iou import rotated_iou_matrix as j_iou
from detection_3d_tpu_torch.ops.rotated_iou import (
    PARK_QUERIES, PARK_TARGETS, _extents, iou_may_meet, park_invalid,
    rotated_iou_matrix, rotated_iou_pairs, rotated_iou_plain,
)
from torch_iou_cases import adversarial_bev


def _family(name, seed=0):
    rng = np.random.RandomState(seed)
    if name == "adversarial":
        return adversarial_bev(seed)
    if name == "random":
        return np.c_[rng.uniform(-3, 3, (120, 2)), rng.uniform(0.1, 2.5,
                                                                 (120, 2)),
                      rng.uniform(-3.2, 3.2, (120, 1))]
    if name == "touching":      # shared edges and corners on a unit grid
        xs, ys = np.meshgrid(np.arange(6.0), np.arange(6.0))
        return np.c_[xs.ravel(), ys.ravel(), np.ones((36, 2)),
                     np.zeros((36, 1))]
    if name == "identical_nested":
        b = rng.uniform(0.5, 3, (20, 2))
        c = rng.uniform(-2, 2, (20, 2))
        a = rng.uniform(-1.6, 1.6, (20, 1))
        return np.r_[np.c_[c, b, a], np.c_[c, b, a], np.c_[c, b * 0.5, a]]
    if name == "thin":          # min / max < 0.25
        return np.c_[rng.uniform(-3, 3, (80, 2)), rng.uniform(2, 6, (80, 1)),
                     rng.uniform(0.01, 0.2, (80, 1)),
                     rng.choice([0, np.pi / 2, 0.3], (80, 1))]
    if name == "rotated45":
        return np.c_[rng.uniform(-2, 2, (80, 2)), rng.uniform(0.2, 2, (80, 2)),
                     np.full((80, 1), np.pi / 4)]
    if name == "zero_size":
        sizes = rng.choice([0.0, 1e-9, 1.0], (60, 2))
        return np.c_[rng.uniform(-1, 1, (60, 2)), sizes,
                     rng.uniform(-1, 1, (60, 1))]
    # pad_scene's padding: copies of one 0.1-size box at the origin, with
    # a few real boxes and anchors of pad rows at the origin
    pad = np.tile([[0, 0, 0.1, 0.1, 0]], (40, 1))
    anchors = np.tile([[0, 0, 0.4, 1.5, 0], [0, 0, 0.4, 1.5, np.pi / 2]],
                      (10, 1))
    real = np.c_[rng.uniform(-5, 5, (20, 2)), rng.uniform(0.1, 4, (20, 2)),
                 rng.uniform(-1.6, 1.6, (20, 1))]
    return np.r_[real, pad, anchors]


FAMILIES = ["adversarial", "random", "touching", "identical_nested", "thin",
            "rotated45", "zero_size", "padded"]


@pytest.mark.parametrize("family", FAMILIES)
def test_cull_never_rules_out_a_meeting_pair(family):
    b = torch.from_numpy(_family(family).astype(np.float32))
    meet = iou_may_meet(b, b)
    inter = rotated_iou_plain(b, b, criterion=3)
    ruled_out = inter[~meet]
    # exactly +0: the kernel writes the criterion's formula at inter = +0
    assert bool((ruled_out.view(torch.int32) == 0).all())
    assert not bool((inter > 0)[~meet].any())


def test_cull_rules_out_most_pairs_of_a_spread_layout():
    """Wall-like gt boxes over a 40 m building against an anchor grid:
    the cull leaves a few percent of the pairs."""
    rng = np.random.RandomState(3)
    gt = np.c_[rng.uniform(0, 40, (100, 2)), rng.uniform(0.1, 4, (100, 2)),
               rng.choice([0, np.pi / 2], (100, 1))]
    xs, ys = np.meshgrid(np.arange(0, 40, 0.5), np.arange(0, 40, 0.5))
    anchors = np.c_[xs.ravel(), ys.ravel(), np.full((xs.size, 2), [0.4, 1.5]),
                    np.zeros((xs.size, 1))]
    meet = iou_may_meet(torch.from_numpy(gt.astype(np.float32)),
                        torch.from_numpy(anchors.astype(np.float32)))
    assert float(meet.float().mean()) < 0.05


def test_cull_keeps_non_finite_and_degenerate_boxes():
    b = torch.tensor([[np.nan, 0, 1, 1, 0], [np.inf, 0, 1, 1, 0],
                      [0, 0, 0, 1, 0], [50, 50, 0, 0, 0]], dtype=torch.float32)
    far = torch.tensor([[100, 100, 1, 1, 0]], dtype=torch.float32)
    assert bool(iou_may_meet(b, far).all())
    assert bool(iou_may_meet(far, b).all())


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_folded_same_box_fix_matches_jax(criterion):
    rng = np.random.RandomState(criterion + 9)
    boxes = np.c_[rng.uniform(-3, 3, (30, 2)), rng.uniform(0.1, 2.5, (30, 2)),
                  rng.choice([0.0, np.pi / 2, 0.7], (30, 1))]
    query = np.r_[boxes[:10], boxes[:5] + 5e-7, boxes[5:10] + 2e-6,
                  np.c_[rng.uniform(-3, 3, (20, 2)),
                        rng.uniform(0.1, 2.5, (20, 2)),
                        rng.uniform(-1.6, 1.6, (20, 1))]]
    boxes, query = boxes.astype(np.float32), query.astype(np.float32)
    want = np.asarray(j_iou(jnp.asarray(boxes), jnp.asarray(query),
                            criterion=criterion, same_box_fix=True,
                            impl="xla"))
    tb, tq = torch.from_numpy(boxes), torch.from_numpy(query)
    got = rotated_iou_plain(tb, tq, criterion, same_box_fix=True).numpy()
    same = np.all(np.abs(boxes[:, None, :] - query[None, :, :])
                  < np.float32(1e-6), axis=-1)
    assert same.sum() >= 15
    np.testing.assert_array_equal(got[same], 1.0)
    np.testing.assert_allclose(got[same], want[same], atol=1e-6, rtol=0)
    # rotated_iou_matrix takes the folded fix and gives what the fix
    # applied outside the plain version gave
    dif = torch.abs(tb[:, None, :] - tq[None, :, :])
    old = torch.where(torch.all(dif < 1e-6, dim=-1), 1.0,
                      rotated_iou_plain(tb, tq, criterion))
    assert torch.equal(rotated_iou_matrix(tb, tq, criterion), old)


def test_parked_rows_are_culled_against_every_box():
    """park_invalid keeps the valid rows and moves the others to unit
    boxes that the cull rules out against every finite, non-degenerate
    box of the adversarial set and against each other (targets and
    queries park apart). A map's pad row at the INVALID coordinate, whose
    edges collapse in float32, is never culled where it stands."""
    bev = adversarial_bev()
    boxes = np.zeros((bev.shape[0], 7), np.float32)
    boxes[:, [0, 1, 3, 4, 6]] = bev
    boxes[:, 5] = 1.0
    tb = torch.from_numpy(boxes)
    valid = torch.from_numpy(np.arange(bev.shape[0]) % 3 != 0)
    real = torch.from_numpy(bev)
    real = real[torch.isfinite(_extents(real)[0])]    # cullable boxes
    bev_cols = [0, 1, 3, 4, 6]
    for at in (PARK_TARGETS, PARK_QUERIES):
        parked = park_invalid(tb, valid, at)
        assert torch.equal(parked[valid].view(torch.int32),      # NaNs too
                           tb[valid].view(torch.int32))
        assert not bool(iou_may_meet(parked[~valid][:, bev_cols], real).any())
        assert not bool(iou_may_meet(real, parked[~valid][:, bev_cols]).any())
    t = park_invalid(tb, valid, PARK_TARGETS)[~valid][:, bev_cols]
    q = park_invalid(tb, valid, PARK_QUERIES)[~valid][:, bev_cols]
    assert not bool(iou_may_meet(t, q).any())
    pad_anchor = torch.tensor([[2 ** 31 * 32 / 50] * 2 + [0.4, 1.5, 0.0]],
                              dtype=torch.float32)
    assert bool(iou_may_meet(pad_anchor, real).all())


@pytest.mark.parametrize("family", FAMILIES)
def test_pairs_route_gives_the_plain_bits(family):
    """The bare intersection (criterion 3), the part the two routes
    compute apart, bit for bit (NaNs included) on each box family against
    itself, against the adversarial set and against parked rows; and
    every criterion with the same-box fix (the shared finish) on one of
    them."""
    b = torch.from_numpy(_family(family).astype(np.float32))
    adv = torch.from_numpy(adversarial_bev(1))
    valid = torch.from_numpy(np.arange(b.shape[0]) % 4 != 1)
    full = torch.zeros((b.shape[0], 7))
    full[:, [0, 1, 3, 4, 6]] = b
    parked = park_invalid(full, valid, PARK_QUERIES)[:, [0, 1, 3, 4, 6]]
    cases = [(b, b, 3, False), (adv, b, 3, False), (b, parked, 3, False)]
    cases += [(adv, b, c, True) for c in (-1, 0, 1, 2)]
    for t, q, criterion, fix in cases:
        want = rotated_iou_plain(t, q, criterion, fix)
        got = rotated_iou_pairs(t, q, criterion, fix)
        assert torch.equal(got.view(torch.int32),
                           want.view(torch.int32)), (criterion, fix)
