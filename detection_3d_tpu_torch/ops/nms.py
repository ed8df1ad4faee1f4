"""Greedy rotated NMS with static output shapes.

Counterpart of detection_3d_tpu/ops/nms.py. Boxes are sorted by score
(stable, descending, so ties keep the lowest index first as
``jnp.argsort(descending=True)`` does), the 3D IoU matrix is built in
that order (kernel C on the card), and a greedy pass suppresses every
later box whose IoU with a kept box exceeds the threshold.

The greedy pass is sequential over rows. It runs on the host over the
boolean "IoU > threshold" matrix: one device-to-host copy of N^2 bytes,
then one vector OR per kept row, instead of N small device launches.
:func:`nms_from_iou` runs the same pass on a given IoU matrix, and
:func:`rotate_nms_3d` is the JAX package's name for :func:`nms_boxes`.
"""

from __future__ import annotations

import numpy as np
import torch

from detection_3d_tpu_torch.ops.rotated_iou import boxes_iou_3d


def greedy_suppress(over, valid_o, post_max_size: int):
    """Greedy pass over ``over`` = (IoU > threshold), already in score
    order. Row i, when not suppressed, suppresses every j > i it
    overlaps; invalid rows start suppressed.

    Returns (keep_pos (post_max_size,) int32 positions into the sorted
    order, padded -1; keep_count 0-d int32), on ``over``'s device.
    """
    dev = over.device
    over_np = over.cpu().numpy()
    sup = ~valid_o.cpu().numpy()
    n = sup.shape[0]
    for i in range(n):
        if not sup[i]:
            sup[i + 1:] |= over_np[i, i + 1:]
    kept = np.flatnonzero(~sup)[:post_max_size]
    keep_pos = np.full((post_max_size,), -1, np.int32)
    keep_pos[:kept.size] = kept
    return (torch.from_numpy(keep_pos).to(dev),
            torch.tensor(kept.size, dtype=torch.int32, device=dev))


def _score_order(scores, valid):
    """Indices by descending score, stable, invalid rows last."""
    neg = torch.finfo(scores.dtype).min
    return torch.sort(torch.where(valid, scores, neg), descending=True,
                      stable=True).indices


def _keep(over_o, valid, order, post_max_size: int):
    """:func:`greedy_suppress` over ``over_o`` (in ``order``), its kept
    positions mapped back to the input order."""
    keep_pos, keep_count = greedy_suppress(over_o, valid[order],
                                           post_max_size)
    keep_idx = torch.where(keep_pos >= 0,
                           order[keep_pos.clamp(min=0).to(torch.int64)], -1)
    return keep_idx.to(torch.int32), keep_count


def nms_boxes(boxes, scores, valid, iou_threshold: float,
              post_max_size: int):
    """Sort-then-IoU greedy NMS on yx_zb boxes (N, 7).

    Returns (keep_idx (post_max_size,) int32 into the ORIGINAL order,
    score-descending, padded -1; keep_count 0-d int32).
    """
    order = _score_order(scores, valid)
    boxes_o = boxes[order]
    iou_o = boxes_iou_3d(boxes_o, boxes_o, criterion=-1)
    return _keep(iou_o > iou_threshold, valid, order, post_max_size)


def nms_from_iou(iou, scores, valid, iou_threshold: float,
                 post_max_size: int):
    """Greedy NMS given a full (N, N) IoU matrix in the input order:
    boxes taken by descending score (stable), each suppressing the later
    ones it overlaps by more than ``iou_threshold``; invalid rows never
    kept. Returns (keep_idx (post_max_size,) int32 into the input order,
    padded -1; keep_count 0-d int32)."""
    order = _score_order(scores, valid)
    return _keep(iou[order][:, order] > iou_threshold, valid, order,
                 post_max_size)


def rotate_nms_3d(boxes, scores, valid, iou_threshold: float,
                  post_max_size: int):
    """Rotated 3D NMS on yx_zb boxes (N, 7), any pre-top-k already
    applied (the reference's pre_max_size): :func:`nms_boxes`, so its
    IoU matrix comes from kernel C on the card. Returns (keep_idx
    (post_max_size,), keep_count)."""
    return nms_boxes(boxes, scores, valid, iou_threshold, post_max_size)
