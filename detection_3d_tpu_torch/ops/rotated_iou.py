"""Exact rotated-rectangle IoU and its 3D composition.

Counterpart of detection_3d_tpu/ops/rotated_iou.py. Each pair's convex
intersection is taken over a static buffer of 24 candidate vertices with
validity masks (4 query corners inside the target, 4 target corners
inside the query, 16 query-edge x target-edge intersections), ordered
around their centroid by a sort-free rank and measured by the shoelace
formula. result[i, j] = iou(boxes_i as target, query_j as anchor).

IoU criteria (rbox1 = query, rbox2 = target box):
  -1 : inter / union
   0 : inter / area(query)
   1 : inter / area(box)
   2 : thin-box rule — if min(d)/max(d) of the *box* < 0.25,
       inter / (area_box + max(0, 0.5*area_query - inter)); else union.

:func:`rotated_iou_matrix` launches the hand-written CUDA kernel
(csrc/rotated_iou.cu) for tensors on the card and takes the plain
:func:`rotated_iou_plain` for tensors on the CPU. The plain version
works on explicit (N, K) pair matrices in the kernel's operation order.
"""

from __future__ import annotations

import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.geometry import rbbox_corners_2d

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


def rotated_iou_plain(boxes, query_boxes, criterion: int = -1):
    """Plain version of kernel C: (N, 5) x (K, 5) -> (N, K) f32."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    bc = rbbox_corners_2d(boxes)                     # (N, 4, 2)
    qc = rbbox_corners_2d(query_boxes)               # (K, 4, 2)
    # targets as (N, 1) columns, queries as (1, K) rows
    bx = [bc[:, t, 0][:, None] for t in range(4)]
    by = [bc[:, t, 1][:, None] for t in range(4)]
    qx = [qc[:, t, 0][None, :] for t in range(4)]
    qy = [qc[:, t, 1][None, :] for t in range(4)]
    shape = (n, k)

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
    cnt = torch.zeros(shape, dtype=torch.float32, device=boxes.device)
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
        r = torch.zeros(shape, dtype=torch.int32, device=boxes.device)
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
    inter = 0.5 * torch.abs(area2)

    area_q = (query_boxes[:, 2] * query_boxes[:, 3])[None, :]
    area_b = (boxes[:, 2] * boxes[:, 3])[:, None]
    union = area_q + area_b - inter
    if criterion == -1:
        return inter / union
    if criterion == 0:
        return inter / area_q
    if criterion == 1:
        return inter / area_b
    if criterion == 2:
        mx = torch.maximum(boxes[:, 2], boxes[:, 3])[:, None]
        mn = torch.minimum(boxes[:, 2], boxes[:, 3])[:, None]
        thin = mn / mx < 0.25
        thin_denom = area_b + torch.clamp(area_q * 0.5 - inter, min=0.0)
        return torch.where(thin, inter / thin_denom, inter / union)
    return inter


def rotated_iou_cuda(boxes, query_boxes, criterion: int = -1):
    """Kernel C on the card: same contract as :func:`rotated_iou_plain`."""
    if (boxes.dtype != torch.float32 or query_boxes.dtype != torch.float32
            or boxes.ndim != 2 or boxes.shape[1] != 5
            or query_boxes.ndim != 2 or query_boxes.shape[1] != 5
            or query_boxes.device != boxes.device):
        raise ValueError("rotated_iou_cuda: expected float32 (N, 5) and "
                         "(K, 5) boxes on one device")
    boxes = boxes.contiguous()
    query_boxes = query_boxes.contiguous()
    n, k = boxes.shape[0], query_boxes.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=boxes.device)
    if n == 0 or k == 0:
        return out
    status = cuda_lib.library("rotated_iou").rotated_iou_matrix(
        boxes.data_ptr(), query_boxes.data_ptr(), n, k, criterion,
        out.data_ptr(), cuda_lib.stream_ptr(boxes.device))
    cuda_lib.check("rotated_iou", status)
    cuda_lib.launches["rotated_iou"] += 1
    return out


def rotated_iou_matrix(boxes, query_boxes, criterion: int = -1):
    """(N, 5) x (K, 5) -> (N, K) rotated IoU: kernel C on the card, the
    plain version on the CPU. (Near-)identical 5-DoF boxes are then forced
    to IoU 1 (the reference's check_same_boxes): the inclusive corner
    tests can give an identical pair IoU 0."""
    boxes = boxes.to(torch.float32)
    query_boxes = query_boxes.to(torch.float32)
    if boxes.is_cuda:
        iou = rotated_iou_cuda(boxes, query_boxes, criterion)
    else:
        iou = rotated_iou_plain(boxes, query_boxes, criterion)
    dif = torch.abs(boxes[:, None, :] - query_boxes[None, :, :])
    return torch.where(torch.all(dif < 1e-6, dim=-1), 1.0, iou)


def z_interval_iou(targets_z, anchors_z):
    """z-overlap ratio of (N, 2) [z_start, z_size] intervals: overlap over
    common extent, negative when disjoint. Returns (N_t, N_a)."""
    t0 = targets_z[:, 0][:, None]
    t1 = (targets_z[:, 0] + targets_z[:, 1])[:, None]
    a0 = anchors_z[:, 0][None, :]
    a1 = (anchors_z[:, 0] + anchors_z[:, 1])[None, :]
    overlap = torch.minimum(a1, t1) - torch.maximum(a0, t0)
    common = torch.maximum(a1, t1) - torch.minimum(a0, t0)
    return overlap / common


_BEV = [0, 1, 3, 4, 6]


def boxes_iou_3d(targets, anchors, aug_thickness=None, criterion: int = -1,
                 only_xy: bool = False):
    """3D IoU of yx_zb boxes: (N_t, 7) x (N_a, 7) -> (N_t, N_a).

    ``aug_thickness``: optional dict with keys target_Y/target_Z/anchor_Y/
    anchor_Z — minimum sizes applied before the IoU. The BEV box is
    columns [0, 1, 3, 4, 6] = (x, y, y_size, x_size, yaw).
    """
    targets = targets.to(torch.float32).clone()
    anchors = anchors.to(torch.float32).clone()
    if aug_thickness is not None:
        targets[:, 3].clamp_(min=aug_thickness["target_Y"])
        anchors[:, 3].clamp_(min=aug_thickness["anchor_Y"])
        targets[:, 5].clamp_(min=aug_thickness["target_Z"])
        anchors[:, 5].clamp_(min=aug_thickness["anchor_Z"])
    iou2d = rotated_iou_matrix(targets[:, _BEV], anchors[:, _BEV],
                               criterion=criterion)
    if only_xy:
        return iou2d
    iouz = z_interval_iou(targets[:, [2, 5]], anchors[:, [2, 5]])
    return iou2d * iouz
