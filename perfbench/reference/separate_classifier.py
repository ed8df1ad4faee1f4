"""Separate-classifier (multi-group, 3G6c) support.

Counterpart of detection_3d_tpu/models/separate_classifier.py (reference
seperate_classifier.py:7-321):

  * group 0 = the remaining class ids (background included); each
    separated group g >= 1 gets a fresh background id
    ``num_classes + g - 1`` in front, so the shared ROI head predicts
    ``num_classes + G - 1`` class columns;
  * per group: gt validity masked by membership, labels remapped to
    group-local indices; RPN objectness column gi and box columns
    [7gi, 7gi + 7) belong to group gi;
  * the ROI loss and post-process take the group's class columns and run
    in the group-local label space; detections map back to the original
    ids at the end.

Static shapes: membership is a validity mask, no row is filtered, so
every group sees the same (max_gt,) padded arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from perfbench.reference.config import Config
from perfbench.reference.structures import Boxes3D
from perfbench.reference.device import device_constant


def grouped_class_ids(cfg: Config) -> Tuple[Tuple[int, ...], ...]:
    """Global class-id columns of each group (seperate_classifier.py:26-36)."""
    nc = cfg.num_classes
    sep = [sorted(grp) for grp in cfg.separate_classes_id()]
    flat = {c for grp in sep for c in grp}
    groups = [tuple(c for c in range(nc) if c not in flat)]
    for gi, grp in enumerate(sep):
        groups.append((nc + gi,) + tuple(grp))
    return tuple(groups)


def org_to_group_local(cfg: Config, device=None):
    """(nc_total, 2) int32 table: original label -> (group, local index)."""
    groups = grouped_class_ids(cfg)
    table = np.full((cfg.num_classes + len(cfg.separate_classes), 2), -1,
                    np.int32)
    for gi, grp in enumerate(groups):
        for li, c in enumerate(grp):
            table[c] = (gi, li)
    return torch.from_numpy(table).to(device)


def separate_targets(cfg: Config, gt: Boxes3D, gt_labels):
    """One (Boxes3D with membership-masked validity, local labels) per
    group; the boxes and fields are the gt's own."""
    table = org_to_group_local(cfg, gt_labels.device)
    safe = torch.clamp(gt_labels.to(torch.int64), 0, table.shape[0] - 1)
    gid, lid = table[safe, 0], table[safe, 1]
    out = []
    for gi in range(cfg.group_num):
        member = (gid == gi) & gt.valid
        out.append((Boxes3D(gt.boxes, member, gt.fields),
                    torch.where(member, lid, 0)))
    return out


def slice_group_logits(cfg: Config, class_logits, box_regression, gi: int):
    """The head's outputs (..., R, ...) -> group gi's class columns and
    their 7-wide box columns (seperate_classifier.py:221-238)."""
    cols = device_constant(grouped_class_ids(cfg)[gi], torch.int64,
                           class_logits.device)
    lead = box_regression.shape[:-1]
    nc_total = cfg.num_classes + len(cfg.separate_classes)
    reg = box_regression.reshape(lead + (nc_total, 7))[..., cols, :]
    return class_logits[..., cols], reg.reshape(lead + (-1,))


def merge_group_detections(cfg: Config, results_g: List[Boxes3D]) -> Boxes3D:
    """Concatenate the groups' detections (along each building's rows),
    local labels mapped back to the original ids
    (seperate_classifier.py:297-321)."""
    groups = grouped_class_ids(cfg)
    boxes, valid, scores, labels = [], [], [], []
    for gi, det in enumerate(results_g):
        local_to_org = device_constant(groups[gi], torch.int32,
                                       det.boxes.device)
        lab = det.fields["labels"].to(torch.int64)
        labels.append(local_to_org[torch.clamp(lab, 0, len(groups[gi]) - 1)])
        boxes.append(det.boxes)
        valid.append(det.valid)
        scores.append(det.fields["scores"])
    return Boxes3D(torch.cat(boxes, -2), torch.cat(valid, -1),
                   {"scores": torch.cat(scores, -1),
                    "labels": torch.cat(labels, -1)})
