"""Greedy rotated NMS with static output shapes.

Counterpart of detection_3d_tpu/ops/nms.py. Boxes are sorted by score
(stable, descending, so ties keep the lowest index first as
``jnp.argsort(descending=True)`` does), the 3D IoU matrix is built in
that order (kernel C on the card), and a greedy pass suppresses every
later box whose IoU with a kept box exceeds the threshold.

Every function takes G independent problems at once, as the JAX package
vmaps its NMS over classes and buildings: boxes (G, N, 7) give keep
positions (G, post) and counts (G,), one kernel C and one kernel E
launch for all G; a problem without the leading axis is the G = 1 case.

The greedy pass takes the score-ordered float32 IoU matrices and the
threshold, as JAX's ``_greedy_suppress`` does, and compares in float32.
On the card it is kernel E (csrc/greedy_nms.cu), two launches: a pack
over every SM turns the upper triangle's "IoU > threshold" into bits,
then one block a matrix walks its rows in order: up to N = 8192 the
suppressed set as a bit mask in registers and the bit rows streamed
into shared memory by bulk copies, above it the mask in shared memory
and the bit rows read where they lie; nothing goes to the host. On the
CPU the plain :func:`greedy_plain` compares in torch and runs the same
pass in numpy, one vector OR per kept row.
:func:`nms_from_iou` runs it on a given IoU matrix, and
:func:`rotate_nms_3d` is the JAX package's name for :func:`nms_boxes`.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.rotated_iou import boxes_iou_3d

# kernel E's largest matrix side: a suppressed mask of 16,384 words in
# shared memory. The (N, N) float32 matrix at that side would take 4 TB,
# so every matrix a card can hold is taken.
GREEDY_MAX_N = 1 << 20


def greedy_plain(iou_o, valid_o, iou_threshold: float, post_max_size: int):
    """Plain version of kernel E: the greedy pass over ``iou_o`` (G, N, N)
    IoU matrices, each already in score order. Row i, when not
    suppressed, suppresses every j > i with IoU > ``iou_threshold``
    (compared in the matrix's dtype, as torch and JAX compare a tensor
    with a Python float; NaN never exceeds it); invalid rows start
    suppressed.

    Returns (keep_pos (G, post_max_size) int32 positions into the sorted
    order, ascending, padded -1; keep_count (G,) int32, at most
    post_max_size), on ``iou_o``'s device."""
    dev = iou_o.device
    over_np = (iou_o > iou_threshold).cpu().numpy()
    sup_all = ~valid_o.cpu().numpy()
    g = over_np.shape[0]
    keep_pos = np.full((g, post_max_size), -1, np.int32)
    counts = np.zeros((g,), np.int32)
    for m in range(g):
        sup = sup_all[m]
        for i in range(sup.shape[0]):
            if not sup[i]:
                sup[i + 1:] |= over_np[m, i, i + 1:]
        kept = np.flatnonzero(~sup)[:post_max_size]
        keep_pos[m, :kept.size] = kept
        counts[m] = kept.size
    return torch.from_numpy(keep_pos).to(dev), torch.from_numpy(counts).to(dev)


def greedy_suppress(iou_o, valid_o, iou_threshold: float,
                    post_max_size: int):
    """The greedy pass over (G, N, N) score-ordered IoU matrices:
    :func:`greedy_plain`."""
    return greedy_plain(iou_o, valid_o, iou_threshold, post_max_size)


def _score_order(scores, valid):
    """Indices by descending score along the last axis, stable, invalid
    rows last."""
    neg = torch.finfo(scores.dtype).min
    return torch.sort(torch.where(valid, scores, neg), dim=-1,
                      descending=True, stable=True).indices


def _keep(iou_o, valid, order, iou_threshold: float, post_max_size: int):
    """:func:`greedy_suppress` over ``iou_o`` (G, N, N) (in ``order``,
    (G, N)), its kept positions mapped back to the input order."""
    valid_o = valid.gather(-1, order)
    keep_pos, keep_count = greedy_suppress(iou_o, valid_o, iou_threshold,
                                           post_max_size)
    picked = order.gather(-1, keep_pos.clamp(min=0).to(torch.int64))
    keep_idx = torch.where(keep_pos >= 0, picked, -1)
    return keep_idx.to(torch.int32), keep_count


def _problems(valid):
    """(lead shape, G) of problems whose validity is ``valid`` (..., N)."""
    lead = valid.shape[:-1]
    return lead, int(np.prod(lead, dtype=np.int64))


def nms_boxes(boxes, scores, valid, iou_threshold: float,
              post_max_size: int):
    """Sort-then-IoU greedy NMS on yx_zb boxes (..., N, 7), one problem
    per leading index.

    Returns (keep_idx (..., post_max_size) int32 into the ORIGINAL order,
    score-descending, padded -1; keep_count (...) int32)."""
    lead, g = _problems(valid)
    n = valid.shape[-1]
    scores, valid = scores.reshape(g, n), valid.reshape(g, n)
    order = _score_order(scores, valid)
    boxes_o = boxes.reshape(g, n, 7).gather(
        1, order[..., None].expand(g, n, 7))
    iou_o = boxes_iou_3d(boxes_o, boxes_o, criterion=-1)
    keep_idx, keep_count = _keep(iou_o, valid, order, iou_threshold,
                                 post_max_size)
    return (keep_idx.reshape(lead + (post_max_size,)),
            keep_count.reshape(lead))


def nms_from_iou(iou, scores, valid, iou_threshold: float,
                 post_max_size: int):
    """Greedy NMS given full (..., N, N) IoU matrices in the input order:
    boxes taken by descending score (stable), each suppressing the later
    ones it overlaps by more than ``iou_threshold`` (compared in the
    matrices' dtype, as JAX compares them); invalid rows never kept. Returns (keep_idx (..., post_max_size) int32 into the input
    order, padded -1; keep_count (...) int32)."""
    lead, g = _problems(valid)
    n = valid.shape[-1]
    scores, valid = scores.reshape(g, n), valid.reshape(g, n)
    order = _score_order(scores, valid)
    iou = iou.reshape(g, n, n)
    rows = iou.gather(1, order[..., None].expand(g, n, n))
    iou_o = rows.gather(2, order[:, None, :].expand(g, n, n))
    keep_idx, keep_count = _keep(iou_o, valid, order, iou_threshold,
                                 post_max_size)
    return (keep_idx.reshape(lead + (post_max_size,)),
            keep_count.reshape(lead))


def rotate_nms_3d(boxes, scores, valid, iou_threshold: float,
                  post_max_size: int):
    """Rotated 3D NMS on yx_zb boxes (N, 7), any pre-top-k already
    applied (the reference's pre_max_size): :func:`nms_boxes`, so its
    IoU matrix comes from kernel C on the card. Returns (keep_idx
    (post_max_size,), keep_count)."""
    return nms_boxes(boxes, scores, valid, iou_threshold, post_max_size)
