"""Functions of the port's ported modules that the detector's paths do
not call, against the JAX package's, on the CPU:

1. ops/geometry.box3d_corners: within 1e-5 (f32 sin/cos of yaw);
2. ops/rotated_iou.rotated_iou_pair, one pair at a time over the
   adversarial box set of tests/torch_iou_cases.py, criteria -1..3:
   within 1e-5 of JAX's jitted pair or, where that one differs, of its
   eager pair (the form JAX's data preparation calls), NaN where JAX
   gives NaN, on every pair that float32 resolves: two distinct boxes within
   1 km of the origin with edges of 1 mm or more, and the non-finite
   ones (582 of the 745 distinct pairs). The others are ill-conditioned
   in float32, and there the JAX package disagrees with itself: its
   jitted and eager forms of one pair differ by up to O(1) (boxes at
   4.3e7 and 1.4e9 m, where a float32 step is 4 and 128 m: -1.819
   jitted, 0.202 eager; a box against itself, the case the reference's
   same-box fix exists for: 2.149 jitted, 0.0 eager). The port gives
   JAX's eager value on all but 9 of those 1131 pairs (a box against
   itself, and a 0.4 m box at 4.3e7 and 1.4e9 m);
3. ops/nms.nms_from_iou and rotate_nms_3d: keep sets identical;
4. build_sparse_tensor(reduce="max"): bit exact, with and without the
   capacity overflow;
5. the box codec's log form (smooth_dim=False): within 1e-6 relative;
6. ops/sparse.conv_rulebook and ops/sparse_conv.deconv_rulebook (the
   searched books, kernel D on the card): bit exact against JAX's
   searched books over its three lookup forms (search, dense grid, xy
   columns), and equal to the scatter-derived books;
7. ops/norm.batch_stats: within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops import box_coder as jcoder
from detection_3d_tpu.ops import geometry as jgeom
from detection_3d_tpu.ops import nms as jnms
from detection_3d_tpu.ops import norm as jnorm
from detection_3d_tpu.ops import rotated_iou as jiou
from detection_3d_tpu.ops import sparse as jsparse
from detection_3d_tpu.ops import sparse_conv as jsconv
from detection_3d_tpu_torch.ops import box_coder as tcoder
from detection_3d_tpu_torch.ops import geometry as tgeom
from detection_3d_tpu_torch.ops import nms as tnms
from detection_3d_tpu_torch.ops import norm as tnorm
from detection_3d_tpu_torch.ops import rotated_iou as tiou
from detection_3d_tpu_torch.ops import sparse as tsparse
from detection_3d_tpu_torch.ops import sparse_conv as tsconv
from test_torch_common import random_coords, table_pair
from torch_iou_cases import adversarial_bev


def test_box3d_corners():
    rng = np.random.RandomState(0)
    boxes = np.c_[rng.uniform(-10, 10, (64, 3)), rng.uniform(0.05, 4, (64, 3)),
                  rng.uniform(-3.2, 3.2, (64, 1))].astype(np.float32)
    want = np.asarray(jgeom.box3d_corners(jnp.asarray(boxes)))
    got = tgeom.box3d_corners(torch.from_numpy(boxes))
    assert got.shape == (64, 8, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # leading dimensions pass through
    assert tgeom.box3d_corners(torch.from_numpy(boxes[:6]).reshape(
        2, 3, 7)).shape == (2, 3, 8, 3)


def _pairs():
    """Each adversarial box with the next box and a shuffled partner,
    kept where float32 resolves the pair (see the module docstring):
    (P, 5) queries and targets."""
    b = adversarial_bev().astype(np.float32)
    perm = np.random.RandomState(1).permutation(b.shape[0])
    q = np.concatenate([b, b])
    t = np.concatenate([np.roll(b, -1, 0), b[perm]])
    with np.errstate(invalid="ignore"):
        near = (np.abs(q[:, :2]).max(1) <= 1e3) & \
            (np.abs(t[:, :2]).max(1) <= 1e3)
        edges = (q[:, 2:4].min(1) >= 1e-3) & (t[:, 2:4].min(1) >= 1e-3)
    keep = ~np.all(q == t, axis=1) & (near & edges
                                       | ~np.isfinite(q).all(1)
                                       | ~np.isfinite(t).all(1))
    return q[keep], t[keep]


_JAX_PAIR = {c: jax.jit(jax.vmap(
    lambda q, t, c=c: jiou.rotated_iou_pair(q, t, c))) for c in range(-1, 4)}


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2, 3])
def test_rotated_iou_pair(criterion):
    q, t = _pairs()
    want = np.array(_JAX_PAIR[criterion](jnp.asarray(q), jnp.asarray(t)))
    got = np.array([float(tiou.rotated_iou_pair(
        torch.from_numpy(qi), torch.from_numpy(ti), criterion))
        for qi, ti in zip(q, t)], np.float32)
    off = np.flatnonzero(~np.isclose(got, want, rtol=0, atol=1e-5,
                                     equal_nan=True))
    assert off.size <= 3, off      # jit against eager: a few at most
    for i in off:
        want[i] = float(jiou.rotated_iou_pair(jnp.asarray(q[i]),
                                              jnp.asarray(t[i]), criterion))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert q.shape[0] >= 580 and not np.isfinite(q).all()


def _nms_case(seed, n=200):
    """Clustered yx_zb boxes with some invalid rows and tied scores."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 20, (12, 2))
    pick = rng.randint(0, 12, n)
    boxes = np.c_[centers[pick] + rng.normal(0, 0.3, (n, 2)),
                  rng.uniform(0, 1, (n, 1)), rng.uniform(0.3, 3, (n, 3)),
                  rng.uniform(-1.5, 1.5, (n, 1))].astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    scores[::17] = scores[1]
    valid = rng.rand(n) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_rotate_nms_3d_keep_sets(seed):
    boxes, scores, valid = _nms_case(seed)
    jk, jc = jnms.rotate_nms_3d(jnp.asarray(boxes), jnp.asarray(scores),
                                jnp.asarray(valid), iou_threshold=0.3,
                                post_max_size=64)
    tk, tc = tnms.rotate_nms_3d(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(valid), 0.3, 64)
    assert int(tc) == int(jc) > 0
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_from_iou_keep_sets(seed):
    """The same greedy pass on one given IoU matrix (JAX's, handed to
    both)."""
    boxes, scores, valid = _nms_case(seed)
    iou = np.array(jiou.boxes_iou_3d(jnp.asarray(boxes),
                                     jnp.asarray(boxes)))
    jk, jc = jnms.nms_from_iou(jnp.asarray(iou), jnp.asarray(scores),
                               jnp.asarray(valid), 0.3, 64)
    tk, tc = tnms.nms_from_iou(torch.from_numpy(iou),
                               torch.from_numpy(scores),
                               torch.from_numpy(valid), 0.3, 64)
    assert int(tc) == int(jc) > 0
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_rotate_nms_3d_basic():
    """JAX's own case (tests/test_rotated_iou.py:test_nms_basic)."""
    boxes = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0],
                          [0.05, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0],
                          [0.1, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0],
                          [5.0, 5.0, 0.0, 1.0, 1.0, 1.0, 0.0]])
    keep, count = tnms.rotate_nms_3d(boxes, torch.tensor([0.9, 0.95, 0.8,
                                                          0.5]),
                                     torch.ones(4, dtype=torch.bool), 0.5, 4)
    assert int(count) == 2 and keep.tolist() == [1, 3, -1, -1]


@pytest.mark.parametrize("cap", [64, 512])
def test_build_sparse_tensor_max(cap):
    """256 cells on an 8 x 8 x 4 grid: cap 64 subsamples by the overflow
    stride."""
    rng = np.random.RandomState(cap)
    coords = rng.randint(0, (8, 8, 4, 1), (400, 4)).astype(np.int32)
    feats = rng.randn(400, 3).astype(np.float32)
    valid = rng.rand(400) > 0.2
    args = (coords, feats, valid)
    jt = jsparse.build_sparse_tensor(*(jnp.asarray(a) for a in args),
                                     (8, 8, 4), 1, cap, reduce="max",
                                     return_row_map=True)
    tt = tsparse.build_sparse_tensor(*(torch.from_numpy(a) for a in args),
                                     (8, 8, 4), 1, cap, reduce="max",
                                     return_row_map=True)
    for a, b in zip((jt[0].feats, jt[0].coords, jt[0].num, jt[1]),
                    (tt[0].feats, tt[0].coords, tt[0].num, tt[1])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError):
        tsparse.build_sparse_tensor(torch.from_numpy(coords),
                                    torch.from_numpy(feats), None,
                                    (8, 8, 4), 1, cap, reduce="min")


def _coder_inputs():
    rng = np.random.RandomState(3)
    anchors = np.c_[rng.uniform(-5, 5, (50, 3)), rng.uniform(0.2, 3, (50, 3)),
                    rng.uniform(-1.5, 1.5, (50, 1))].astype(np.float32)
    boxes = anchors * np.float32(1.3) + np.float32(0.1)
    return boxes, anchors


@pytest.mark.parametrize("smooth_dim", [True, False])
def test_box_codec_forms(smooth_dim):
    boxes, anchors = _coder_inputs()
    jb, ja = jnp.asarray(boxes), jnp.asarray(anchors)
    tb, ta = torch.from_numpy(boxes), torch.from_numpy(anchors)
    enc_j = np.asarray(jcoder.second_box_encode(jb, ja, smooth_dim))
    enc_t = tcoder.second_box_encode(tb, ta, smooth_dim)
    np.testing.assert_allclose(enc_t.numpy(), enc_j, rtol=1e-6, atol=1e-6)
    dec_j = np.asarray(jcoder.second_box_decode(jnp.asarray(enc_j), ja,
                                                smooth_dim))
    dec_t = tcoder.second_box_decode(enc_t, ta, smooth_dim)
    np.testing.assert_allclose(dec_t.numpy(), dec_j, rtol=1e-6, atol=1e-6)
    jc = jcoder.BoxCoder3D(smooth_dim=smooth_dim)
    tc = tcoder.BoxCoder3D(smooth_dim=smooth_dim)
    assert tc.bbox_xform_clip == jc.bbox_xform_clip
    np.testing.assert_allclose(tc.encode(tb, ta).numpy(),
                               np.asarray(jc.encode(jb, ja)), rtol=1e-6,
                               atol=1e-6)
    # encodings past the size clip (log(1000) in the log form)
    enc = np.random.RandomState(4).uniform(-3, 12, (50, 14)).astype(
        np.float32)
    np.testing.assert_allclose(
        tc.decode(torch.from_numpy(enc), ta).numpy(),
        np.asarray(jc.decode(jnp.asarray(enc), ja)), rtol=1e-6, atol=1e-5)


def _jax_lookup_forms(t):
    return {"search": t, "dense": t.with_dense_grid(1 << 20),
            "xy": t.with_xy_grid(1 << 20)}


@pytest.mark.parametrize("form", ["search", "dense", "xy"])
def test_searched_books_bit_exact(form):
    spatial = (32, 24, 16)
    coords = random_coords(700, spatial, 11)
    feats = np.zeros((coords.shape[0], 1), np.float32)
    jt, tt = table_pair(coords, feats, spatial, 1024)
    k, s = (2, 2, 2), (2, 2, 2)
    jd = jsparse.downsample_table(jt, k, s, 512)
    td, t_crb, t_drb = tsparse.downsample_with_rulebooks(tt, k, s, 512)
    jin = _jax_lookup_forms(jt)[form]
    jout = _jax_lookup_forms(jd)[form]
    conv = tsparse.conv_rulebook(td, tt, k, s)
    dec = tsconv.deconv_rulebook(tt, td, k, s)
    np.testing.assert_array_equal(
        conv.numpy(), np.asarray(jsparse.conv_rulebook(jd, jin, k, s)))
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jsconv.deconv_rulebook(jt, jout, k, s)))
    assert torch.equal(conv, t_crb) and torch.equal(dec, t_drb)
    assert conv.dtype == dec.dtype == torch.int32


def test_batch_stats():
    rng = np.random.RandomState(5)
    feats = (rng.randn(300, 7) * 3 + 1).astype(np.float32)
    valid = rng.rand(300) > 0.3
    jm, jv = jnorm.batch_stats(jnp.asarray(feats), jnp.asarray(valid))
    tm, tv = tnorm.batch_stats(torch.from_numpy(feats),
                               torch.from_numpy(valid))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
