"""Exact rotated-rectangle IoU and its 3D composition.

Counterpart of detection_3d_tpu/ops/rotated_iou.py. Each pair's convex
intersection is taken over a static buffer of 24 candidate vertices with
validity masks (4 query corners inside the target, 4 target corners
inside the query, 16 query-edge x target-edge intersections), ordered
around their centroid by a sort-free rank and measured by the shoelace
formula. result[i, j] = iou(boxes_i as target, query_j as anchor).
Every function here also takes a batch of G such problems, (G, N, 5) x
(G, K, 5) -> (G, N, K), matrix g over its own boxes alone and equal bit
for bit to its own call (kernel C runs them in one launch).

IoU criteria (rbox1 = query, rbox2 = target box):
  -1 : inter / union
   0 : inter / area(query)
   1 : inter / area(box)
   2 : thin-box rule — if min(d)/max(d) of the *box* < 0.25,
       inter / (area_box + max(0, 0.5*area_query - inter)); else union.

:func:`rotated_iou_matrix` launches the hand-written CUDA kernel
(csrc/rotated_iou.cu) for tensors on the card and takes the plain
:func:`rotated_iou_pairs` for tensors on the CPU. The plain version
works on explicit (N, K) pair matrices in the kernel's operation order
and computes every pair; the kernel, and rotated_iou_pairs, skip the
pairs that :func:`iou_may_meet` rules out, and give them the same bits.
:func:`rotated_iou_pair` is one pair's IoU in plain torch, for host
loops.
"""

from __future__ import annotations

import torch

from perfbench.reference.geometry import rbbox_corners_2d
from perfbench.reference.device import device_constant

_NC = 24
_BIG = 1e9


def _point_in_quad(px, py, qx, qy):
    """Inclusive projection test onto edges ab = q1 - q0, ad = q3 - q0."""
    abx, aby = qx[1] - qx[0], qy[1] - qy[0]
    adx, ady = qx[3] - qx[0], qy[3] - qy[0]
    apx, apy = px - qx[0], py - qy[0]
    abab = abx * abx + aby * aby
    abap = abx * apx + aby * apy
    adad = adx * adx + ady * ady
    adap = adx * apx + ady * apy
    return (abab >= abap) & (abap >= 0.0) & (adad >= adap) & (adap >= 0.0)


_GAP = 1e-3      # extents further apart than this cannot meet
_SAME = 1e-6     # check_same_boxes' tolerance on each of the 5 numbers


def _extents(boxes):
    """(lo_x, hi_x, lo_y, hi_y) per box from its corners, each (..., N), or
    (-inf, inf) for a box that must never be culled: a non-finite corner,
    or a zero edge (its point-in-quad test accepts a whole strip)."""
    c = rbbox_corners_2d(boxes)
    px, py = c[..., 0], c[..., 1]
    abx, aby = px[..., 1] - px[..., 0], py[..., 1] - py[..., 0]
    adx, ady = px[..., 3] - px[..., 0], py[..., 3] - py[..., 0]
    abab = abx * abx + aby * aby
    adad = adx * adx + ady * ady
    ok = (torch.isfinite(c).flatten(-2).all(-1) & torch.isfinite(abab)
          & torch.isfinite(adad) & (abab > 0.0) & (adad > 0.0))
    inf = torch.full_like(abab, float("inf"))
    return (torch.where(ok, px.amin(-1), -inf),
            torch.where(ok, px.amax(-1), inf),
            torch.where(ok, py.amin(-1), -inf),
            torch.where(ok, py.amax(-1), inf))


def iou_may_meet(boxes, query_boxes):
    """(..., N, K) bool: False where kernel C skips the pair because the two
    boxes' extents are more than 1e-3 apart in x or in y (such a pair has
    no valid candidate vertex, so its intersection is +0). A comparison
    that sees a NaN never rules a pair out."""
    b = _extents(boxes.to(torch.float32))
    q = _extents(query_boxes.to(torch.float32))
    b = [e[..., :, None] for e in b]
    q = [e[..., None, :] for e in q]
    apart = ((b[0] - q[1] > _GAP) | (q[0] - b[1] > _GAP)
             | (b[2] - q[3] > _GAP) | (q[2] - b[3] > _GAP))
    return ~apart


def _same_boxes(boxes, query_boxes):
    """(..., N, K) bool: all five |differences| < 1e-6, one (N, K) plane
    at a time."""
    same = None
    for t in range(5):
        s = torch.abs(boxes[..., :, t, None]
                      - query_boxes[..., None, :, t]) < _SAME
        same = s if same is None else same & s
    return same


def rotated_iou_plain(boxes, query_boxes, criterion: int = -1,
                      same_box_fix: bool = False):
    """Plain version of kernel C: (N, 5) x (K, 5) -> (N, K) f32, or a
    batch (G, N, 5) x (G, K, 5) -> (G, N, K), every pair computed.

    ``same_box_fix`` forces pairs whose five numbers all differ by less
    than 1e-6 to 1 (the reference's check_same_boxes)."""
    bc = rbbox_corners_2d(boxes)                     # (..., N, 4, 2)
    qc = rbbox_corners_2d(query_boxes)               # (..., K, 4, 2)
    # targets as (N, 1) columns, queries as (1, K) rows
    inter = _intersection(bc[..., :, None, :, :], qc[..., None, :, :, :])
    return _finish(inter, boxes, query_boxes, criterion, same_box_fix)


def rotated_iou_pairs(boxes, query_boxes, criterion: int = -1,
                      same_box_fix: bool = False):
    """:func:`rotated_iou_plain`'s bits, the intersection computed only
    on the pairs :func:`iou_may_meet` keeps (the others' is +0, as in
    the kernel): the CPU route of :func:`rotated_iou_matrix`, where the
    anchors' pad rows and the far boxes would otherwise cost as much as
    the pairs that meet."""
    meet = iou_may_meet(boxes, query_boxes)
    pair = torch.nonzero(meet, as_tuple=True)    # (g,) target, query
    bc = rbbox_corners_2d(boxes)
    qc = rbbox_corners_2d(query_boxes)
    inter = torch.zeros(meet.shape, dtype=torch.float32,
                        device=boxes.device)
    inter[pair] = _intersection(bc[pair[:-1]], qc[pair[:-2] + pair[-1:]])
    return _finish(inter, boxes, query_boxes, criterion, same_box_fix)


def _finish(inter, boxes, query_boxes, criterion, same_box_fix):
    iou = _criterion(inter, boxes, query_boxes, criterion)
    if same_box_fix:
        iou = torch.where(_same_boxes(boxes, query_boxes), 1.0, iou)
    return iou


def _intersection(bc, qc):
    """Intersection area of target corners ``bc`` (..., 4, 2) and query
    corners ``qc`` (..., 4, 2) whose leading shapes broadcast to the
    pairs' shape."""
    bx = [bc[..., t, 0] for t in range(4)]
    by = [bc[..., t, 1] for t in range(4)]
    qx = [qc[..., t, 0] for t in range(4)]
    qy = [qc[..., t, 1] for t in range(4)]
    shape = torch.broadcast_shapes(bx[0].shape, qx[0].shape)

    xs, ys, vs = [], [], []
    for t in range(4):       # query corners inside the target
        xs.append(qx[t].expand(shape))
        ys.append(qy[t].expand(shape))
        vs.append(_point_in_quad(qx[t], qy[t], bx, by).expand(shape))
    for t in range(4):       # target corners inside the query
        xs.append(bx[t].expand(shape))
        ys.append(by[t].expand(shape))
        vs.append(_point_in_quad(bx[t], by[t], qx, qy).expand(shape))
    for e in range(4):       # query edge e x target edge f
        ax, ay = qx[e], qy[e]
        bx_, by_ = qx[(e + 1) % 4], qy[(e + 1) % 4]
        for f in range(4):
            cx, cy = bx[f], by[f]
            dx, dy = bx[(f + 1) % 4], by[(f + 1) % 4]
            acd = (dy - ay) * (cx - ax) > (cy - ay) * (dx - ax)
            bcd = (dy - by_) * (cx - bx_) > (cy - by_) * (dx - bx_)
            abc = (cy - ay) * (bx_ - ax) > (by_ - ay) * (cx - ax)
            abd = (dy - ay) * (bx_ - ax) > (by_ - ay) * (dx - ax)
            bax, bay = bx_ - ax, by_ - ay
            dcx, dcy = dx - cx, dy - cy
            abba = ax * by_ - bx_ * ay
            cddc = cx * dy - dx * cy
            dh = bay * dcx - bax * dcy
            safe = torch.where(dh == 0.0, 1.0, dh)
            xs.append((abba * dcx - bax * cddc) / safe)
            ys.append((abba * dcy - bay * cddc) / safe)
            vs.append((acd != bcd) & (abc != abd) & (dh != 0.0))

    # centroid of the valid candidates (sums in candidate order)
    cnt = torch.zeros(shape, dtype=torch.float32, device=bc.device)
    sx = torch.zeros_like(cnt)
    sy = torch.zeros_like(cnt)
    for t in range(_NC):
        vf = vs[t].to(torch.float32)
        cnt = cnt + vf
        sx = sx + vf * xs[t]
        sy = sy + vf * ys[t]
    denom = torch.clamp(cnt, min=1.0)
    cxm, cym = sx / denom, sy / denom

    v0 = [xs[t] - cxm for t in range(_NC)]
    v1 = [ys[t] - cym for t in range(_NC)]
    keys = []
    for t in range(_NC):
        d = torch.sqrt(v0[t] * v0[t] + v1[t] * v1[t])
        ds = torch.where(d > 0.0, d, 1.0)
        ux, uy = v0[t] / ds, v1[t] / ds
        key = torch.where(uy < 0.0, -2.0 - ux, ux)
        keys.append(torch.where(vs[t] & (d > 0.0), key, _BIG))

    ranks = []
    for a in range(_NC):
        r = torch.zeros(shape, dtype=torch.int32, device=bc.device)
        for c in range(_NC):
            if c == a:
                continue
            less = keys[c] < keys[a]
            if c < a:          # static index tie-break
                less = less | (keys[c] == keys[a])
            r = r + less.to(torch.int32)
        ranks.append(r)

    nv = cnt.to(torch.int32)
    area2 = torch.zeros_like(cnt)
    for a in range(_NC):
        nxt = torch.where(ranks[a] + 1 >= nv, 0, ranks[a] + 1)
        vnx = torch.zeros_like(cnt)
        vny = torch.zeros_like(cnt)
        for c in range(_NC):
            sel = (ranks[c] == nxt) & vs[c]
            vnx = torch.where(sel, v0[c], vnx)
            vny = torch.where(sel, v1[c], vny)
        cross = v0[a] * vny - v1[a] * vnx
        area2 = area2 + torch.where(vs[a], cross, 0.0)
    return 0.5 * torch.abs(area2)


def _criterion(inter, boxes, query_boxes, criterion):
    area_q = (query_boxes[..., 2] * query_boxes[..., 3])[..., None, :]
    area_b = (boxes[..., 2] * boxes[..., 3])[..., :, None]
    union = area_q + area_b - inter
    if criterion == -1:
        return inter / union
    if criterion == 0:
        return inter / area_q
    if criterion == 1:
        return inter / area_b
    if criterion == 2:
        mx = torch.maximum(boxes[..., 2], boxes[..., 3])[..., :, None]
        mn = torch.minimum(boxes[..., 2], boxes[..., 3])[..., :, None]
        thin = mn / mx < 0.25
        thin_denom = area_b + torch.clamp(area_q * 0.5 - inter, min=0.0)
        return torch.where(thin, inter / thin_denom, inter / union)
    return inter


def _segment_intersections(c1, c2):
    """The 4 x 4 edge-pair intersections of two quads' corners (4, 2):
    (16, 2) points (query edge e x target edge f at 4e + f) and (16,)
    validity, by the orientation tests and the determinant formula of
    :func:`_intersection`."""
    a, b = c1, torch.roll(c1, -1, 0)
    c, d = c2, torch.roll(c2, -1, 0)
    A, B = a[:, None, :], b[:, None, :]
    C, D = c[None, :, :], d[None, :, :]
    BA, DA, CA = B - A, D - A, C - A
    acd = DA[..., 1] * CA[..., 0] > CA[..., 1] * DA[..., 0]
    bcd = ((D[..., 1] - B[..., 1]) * (C[..., 0] - B[..., 0])
           > (C[..., 1] - B[..., 1]) * (D[..., 0] - B[..., 0]))
    abc = CA[..., 1] * BA[..., 0] > BA[..., 1] * CA[..., 0]
    abd = DA[..., 1] * BA[..., 0] > BA[..., 1] * DA[..., 0]
    DC = D - C
    abba = A[..., 0] * B[..., 1] - B[..., 0] * A[..., 1]
    cddc = C[..., 0] * D[..., 1] - D[..., 0] * C[..., 1]
    dh = BA[..., 1] * DC[..., 0] - BA[..., 0] * DC[..., 1]
    safe = torch.where(dh == 0.0, 1.0, dh)
    pts = torch.stack([(abba * DC[..., 0] - BA[..., 0] * cddc) / safe,
                       (abba * DC[..., 1] - BA[..., 1] * cddc) / safe], -1)
    valid = (acd != bcd) & (abc != abd) & (dh != 0.0)
    return pts.reshape(16, 2), valid.reshape(16)


def _intersection_area(c1, c2):
    """Intersection area of one query quad ``c1`` and one target quad
    ``c2``, corners (4, 2) each (JAX ops/rotated_iou._intersection_area):
    the 24 candidates of :func:`_intersection` as (24,) vectors, ranked
    by a (24, 24) comparison and summed by the shoelace formula. A pair
    at a time this takes a few dozen small operations where
    :func:`_intersection`, written for (N, K) planes, takes thousands."""
    in2 = _point_in_quad(c1[:, 0], c1[:, 1], c2[:, 0], c2[:, 1])
    in1 = _point_in_quad(c2[:, 0], c2[:, 1], c1[:, 0], c1[:, 1])
    seg_pts, seg_valid = _segment_intersections(c1, c2)
    pts = torch.cat([c1, c2, seg_pts], 0)                 # (24, 2)
    valid = torch.cat([in2, in1, seg_valid], 0)           # (24,)
    n = valid.sum(dtype=torch.int32)
    vf = valid.to(pts.dtype)
    center = (pts * vf[:, None]).sum(0) / torch.clamp(n, min=1).to(pts.dtype)
    v = pts - center
    d = torch.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2)
    ds = torch.where(d > 0.0, d, 1.0)
    vx, vy = v[:, 0] / ds, v[:, 1] / ds
    key = torch.where(vy < 0.0, -2.0 - vx, vx)
    key = torch.where(valid & (d > 0.0), key, _BIG)
    ar = torch.arange(_NC, device=pts.device)
    less = key[None, :] < key[:, None]
    tie = (key[None, :] == key[:, None]) & (ar[None, :] < ar[:, None])
    rank = (less | tie).sum(1, dtype=torch.int32)
    nxt = torch.where(rank + 1 >= n, 0, rank + 1)
    sel = (rank[None, :] == nxt[:, None]) & valid[None, :]
    vnx = torch.where(sel, v[None, :, 0], 0.0).sum(1)
    vny = torch.where(sel, v[None, :, 1], 0.0).sum(1)
    cross = v[:, 0] * vny - v[:, 1] * vnx
    return 0.5 * torch.abs(torch.where(valid, cross, 0.0).sum())


def rotated_iou_pair(qbox, box, criterion: int = -1):
    """IoU of one query rbbox and one target rbbox, both (5,) ``[cx, cy,
    x_d, y_d, angle]``, as a 0-d tensor (JAX ops/rotated_iou.py:158; the
    reference's devRotateIoUEval(rbox1=qbox, rbox2=box)). Plain torch on
    the tensors' own device: it serves host loops over single pairs
    (data/gt_preprocess._xy_iou), where a kernel launch a pair would
    cost more than the pair."""
    inter = _intersection_area(rbbox_corners_2d(qbox),
                               rbbox_corners_2d(box))
    return _criterion(inter.reshape(1, 1), box[None], qbox[None],
                      criterion)[0, 0]


def rotated_iou_matrix(boxes, query_boxes, criterion: int = -1):
    """(N, 5) x (K, 5) -> (N, K) rotated IoU (or a (G, ...) batch of
    such): the plain version over the pairs that may meet. (Near-)identical 5-DoF boxes are forced to
    IoU 1 (the reference's check_same_boxes, ``same_box_fix``): the
    inclusive corner tests can give an identical pair IoU 0."""
    boxes = boxes.to(torch.float32)
    query_boxes = query_boxes.to(torch.float32)
    return rotated_iou_pairs(boxes, query_boxes, criterion, same_box_fix=True)


def z_interval_iou(targets_z, anchors_z):
    """z-overlap ratio of (..., N, 2) [z_start, z_size] intervals: overlap
    over common extent, negative when disjoint. Returns (..., N_t, N_a)."""
    t0 = targets_z[..., :, 0, None]
    t1 = (targets_z[..., 0] + targets_z[..., 1])[..., :, None]
    a0 = anchors_z[..., None, :, 0]
    a1 = (anchors_z[..., 0] + anchors_z[..., 1])[..., None, :]
    overlap = torch.minimum(a1, t1) - torch.maximum(a0, t0)
    common = torch.maximum(a1, t1) - torch.minimum(a0, t0)
    return overlap / common


_BEV = (0, 1, 3, 4, 6)

# Where :func:`park_invalid` puts rows whose IoU nobody reads: unit boxes
# far from any scene, targets and queries apart from each other.
PARK_TARGETS = (-1.0e6, 0.0)
PARK_QUERIES = (0.0, -1.0e6)


def park_invalid(boxes, valid, at):
    """(N, 7) yx_zb ``boxes`` with every row whose ``valid`` is false
    replaced by a unit box centred at ``at`` = (x, y).

    For a caller of :func:`boxes_iou_3d` that masks the pairs of invalid
    rows afterwards: parked targets (at ``PARK_TARGETS``) and parked
    queries (at ``PARK_QUERIES``) are apart from every real box and from
    each other, so kernel C's extent cull rules out every pair holding
    one. A pad row's own box can be degenerate (a map's pad rows sit at
    the INVALID coordinate with collapsed edges), which the cull must
    keep."""
    unit = torch.tensor([at[0], at[1], 0.0, 1.0, 1.0, 1.0, 0.0],
                        dtype=boxes.dtype, device=boxes.device)
    return torch.where(valid[..., None], boxes, unit)


def boxes_iou_3d(targets, anchors, aug_thickness=None, criterion: int = -1,
                 only_xy: bool = False):
    """3D IoU of yx_zb boxes: (N_t, 7) x (N_a, 7) -> (N_t, N_a), or a
    batch (G, N_t, 7) x (G, N_a, 7) -> (G, N_t, N_a).

    ``aug_thickness``: optional dict with keys target_Y/target_Z/anchor_Y/
    anchor_Z — minimum sizes applied before the IoU; without it the y and
    z sizes are clamped at 0, as the JAX package clamps them. The BEV box
    is columns [0, 1, 3, 4, 6] = (x, y, y_size, x_size, yaw).
    """
    targets = targets.to(torch.float32).clone()
    anchors = anchors.to(torch.float32).clone()
    aug = aug_thickness or {"target_Y": 0.0, "target_Z": 0.0,
                            "anchor_Y": 0.0, "anchor_Z": 0.0}
    targets[..., 3].clamp_(min=aug["target_Y"])
    anchors[..., 3].clamp_(min=aug["anchor_Y"])
    targets[..., 5].clamp_(min=aug["target_Z"])
    anchors[..., 5].clamp_(min=aug["anchor_Z"])
    bev = device_constant(_BEV, torch.int64, targets.device)
    iou2d = rotated_iou_matrix(targets.index_select(-1, bev),
                               anchors.index_select(-1, bev),
                               criterion=criterion)
    if only_xy:
        return iou2d
    z = device_constant((2, 5), torch.int64, targets.device)
    iouz = z_interval_iou(targets.index_select(-1, z),
                          anchors.index_select(-1, z))
    return iou2d * iouz
