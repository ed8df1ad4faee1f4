"""RPN: head, anchors, targets and loss, top-k, decode, rotated NMS.

Counterpart of detection_3d_tpu/models/rpn.py (reference
rpn_sparse3d.py:80-131 for the head, loss_3d.py:88-250 for targets and
loss, rpn/inference_3d.py:53-163 for proposal selection). With
separate-classifier groups (``cfg.separate_rpn``) the head predicts one
objectness column and 7 box columns per group, and the RPN selects
proposals and takes its losses per group.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from perfbench.reference.config import Config
from perfbench.reference.anchors import generate_anchors
from perfbench.reference.losses import (
    bce_with_logits, smooth_l1_box_loss,
)
from perfbench.reference.matcher import (
    BETWEEN, balanced_sample, match_boxes,
)
from perfbench.reference.structures import (
    Boxes3D, concat_boxes, take_rows,
)
from perfbench.reference.box_coder import BoxCoder3D
from perfbench.reference.geometry import limit_period
from perfbench.reference.nms import nms_boxes
from perfbench.reference.rotated_iou import (
    PARK_QUERIES, PARK_TARGETS, boxes_iou_3d, park_invalid,
)
from perfbench.reference.sparse import SparseTensor


def top_k(values, k: int):
    """(values, indices) of the k largest entries along the last axis,
    ties lowest index first — the order of ``jax.lax.top_k``
    (``torch.topk`` promises no order among ties)."""
    out = torch.sort(values, dim=-1, descending=True, stable=True)
    return out.values[..., :k], out.indices[..., :k]


class RPNHead(nn.Module):
    """Shared 1x1 conv + ReLU, then 1x1 cls (A*G logits) and box (A*7*G)
    heads, G = cfg.group_num with ``cfg.separate_rpn``, else 1; weights
    shared across levels (init std 0.01)."""

    def __init__(self, cfg: Config):
        super().__init__()
        a = cfg.rpn.num_anchors_per_location
        g = cfg.group_num if cfg.separate_rpn else 1
        c = cfg.sparse3d.nplane_map
        self.groups = g
        self.conv_w = nn.Parameter(torch.empty(c, c))
        self.conv_b = nn.Parameter(torch.zeros(c))
        self.cls_w = nn.Parameter(torch.empty(c, a * g))
        self.cls_b = nn.Parameter(torch.zeros(a * g))
        self.box_w = nn.Parameter(torch.empty(c, a * 7 * g))
        self.box_b = nn.Parameter(torch.zeros(a * 7 * g))

    def reset_parameters(self, gen):
        with torch.no_grad():
            for w in (self.conv_w, self.cls_w, self.box_w):
                w.normal_(0.0, 0.01, generator=gen)
            for b in (self.conv_b, self.cls_b, self.box_b):
                b.zero_()

    def forward(self, feats_per_level):
        """(N_anchors, G) logits and (N_anchors, 7G) regressions: a
        site's columns are anchor-major, then group (JAX's reshape to
        (-1, A, G) and (-1, A, 7G)), so group gi's objectness is column
        gi and its regression columns [7gi, 7gi + 7). A unit's maps
        (B, V, C) give (B, N_anchors, ...)."""
        g = self.groups
        logits, regs = [], []
        for f in feats_per_level:
            dt = f.dtype
            t = torch.relu(f @ self.conv_w.to(dt) + self.conv_b.to(dt))
            lg = t @ self.cls_w.to(dt) + self.cls_b.to(dt)
            rg = t @ self.box_w.to(dt) + self.box_b.to(dt)
            # box/score math downstream is f32
            lead = lg.shape[:-2]
            logits.append(lg.reshape(lead + (-1, g)).to(torch.float32))
            regs.append(rg.reshape(lead + (-1, 7 * g)).to(torch.float32))
        return torch.cat(logits, -2), torch.cat(regs, -2)


def num_anchors(cfg: Config) -> int:
    """Anchors of one example: the capacities of the RPN maps (a BEV map
    has its 3D table's capacity) times the anchors per site."""
    n = cfg.sparse3d.num_scales
    caps = cfg.caps.scale_caps(n, base=cfg.caps.scale_caps(n)[0])
    slots = cfg.rpn.rpn_scales_from_top
    return sum(caps[n - 1 - slots[i % len(slots)]]
               for i in cfg.rpn.rpn_3d_2d_selector) * \
        cfg.rpn.num_anchors_per_location


def rpn_targets(cfg: Config, anchors: Boxes3D, gt: Boxes3D):
    """Per-anchor label (1 / 0 / -1 ignore), regression target and match
    (loss_3d.py:88-198): IoU criterion 2 with the label-generation
    thickness floors, the |yaw| gate and the low-quality rescue."""
    aug = {"target_Y": cfg.rpn.label_aug_thickness_y_tar_anc[0],
           "anchor_Y": cfg.rpn.label_aug_thickness_y_tar_anc[1],
           "target_Z": cfg.rpn.label_aug_thickness_z_tar_anc[0],
           "anchor_Z": cfg.rpn.label_aug_thickness_z_tar_anc[1]}
    # the matcher reads only valid pairs: parking the pad rows lets the
    # IoU kernel cull their pairs
    quality = boxes_iou_3d(park_invalid(gt.boxes, gt.valid, PARK_TARGETS),
                           park_invalid(anchors.boxes, anchors.valid,
                                        PARK_QUERIES),
                           aug_thickness=aug, criterion=2)
    # yaw difference wrapped into [-pi/2, pi/2)
    ydif = limit_period(gt.boxes[:, 6][:, None] - anchors.boxes[:, 6][None],
                        0.5, math.pi)
    matches = match_boxes(quality, gt.valid, anchors.valid,
                          high=cfg.rpn.fg_iou_threshold,
                          low=cfg.rpn.bg_iou_threshold,
                          allow_low_quality=True, yaw_diff=ydif,
                          yaw_threshold=cfg.rpn.yaw_threshold)
    labels = torch.where(matches >= 0, 1.0, 0.0)
    labels = torch.where(matches == BETWEEN, -1.0, labels)
    labels = torch.where(anchors.valid, labels, -1.0)
    matched_gt = gt.boxes[torch.clamp(matches, min=0).to(torch.int64)]
    reg_targets = BoxCoder3D().encode(matched_gt, anchors.boxes)
    return labels, reg_targets, matches


def rpn_loss(cfg: Config, priorities, anchors: Boxes3D, objectness,
             box_reg, gt: Boxes3D):
    """(loss_objectness, loss_rpn_box_reg) over a balanced sample drawn
    with ``priorities`` (N_anchors,) (loss_3d.py:200-250)."""
    labels, reg_targets, _ = rpn_targets(cfg, anchors, gt)
    pos_mask, neg_mask = balanced_sample(
        labels, priorities, cfg.rpn.batch_size_per_image,
        cfg.rpn.positive_fraction)
    sampled = pos_mask | neg_mask
    n_sampled = torch.clamp(sampled.to(torch.float32).sum(), min=1.0)
    box_l = smooth_l1_box_loss(box_reg, reg_targets, anchors.boxes,
                               pos_mask, beta=1.0 / 9,
                               yaw_loss_mode=cfg.rpn.yaw_loss_mode) / n_sampled
    obj_l = bce_with_logits(objectness, labels, sampled)
    return obj_l, box_l


@torch.no_grad()
def select_proposals(cfg: Config, anchors: Boxes3D, objectness, box_reg,
                     is_train: bool = False, gt: Boxes3D = None):
    """sigmoid -> top-k (pre-NMS) -> decode -> rotated NMS -> top
    post-NMS, plus the gt boxes in training (inference_3d.py:53-163).
    Returns Boxes3D with the fields objectness and is_gt.

    Runs without autograd: proposals are constants for the ROI stage (a
    gradient through the NMS geometry would be NaN on duplicate boxes),
    as the JAX package's stop_gradient makes them. A unit's anchors and
    head outputs (B, N_anchors, ...) give (B, post) proposals: top-k per
    building, then one NMS over the B buildings."""
    pre_n = (cfg.rpn_pre_nms_top_n_train if is_train
             else cfg.rpn_pre_nms_top_n_test)
    post_n = (cfg.rpn_post_nms_top_n_train if is_train
              else cfg.rpn_post_nms_top_n_test)
    pre_n = min(pre_n, objectness.shape[-1])
    score = torch.where(anchors.valid, torch.sigmoid(objectness), -1.0)
    top_score, top_idx = top_k(score, pre_n)
    top_valid = top_score >= 0.0
    dec = BoxCoder3D().decode(take_rows(box_reg, top_idx),
                              take_rows(anchors.boxes, top_idx))

    # NMS with thickness augmentation on y/x sizes and z
    ay, az = cfg.rpn.nms_aug_thickness_y_z
    nms_in = dec.clone()
    nms_in[..., 3:5] = torch.clamp(nms_in[..., 3:5], min=ay)
    nms_in[..., 5] = torch.clamp(nms_in[..., 5], min=az)
    keep_idx, _ = nms_boxes(nms_in, top_score, top_valid, cfg.rpn.nms_thresh,
                            post_n)
    kept = Boxes3D(dec, top_valid, {"objectness": top_score}).gather(keep_idx)
    kept.fields["is_gt"] = torch.zeros(keep_idx.shape, device=dec.device)
    if is_train and cfg.rpn.add_gt_proposals and gt is not None:
        ones = torch.ones((gt.capacity,), device=dec.device)
        kept = concat_boxes(kept, Boxes3D(gt.boxes, gt.valid, {
            "objectness": ones, "is_gt": ones}), ("objectness", "is_gt"))
    return kept


class RPN(nn.Module):
    """Head + anchors + proposal selection per classifier group, and with
    gt the two RPN losses per group."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.head = RPNHead(cfg)

    def forward(self, rpn_maps: List[SparseTensor], gt=None,
                priorities=None):
        """Returns (proposals per group, losses). ``gt`` is None or one
        Boxes3D per group, and then ``priorities`` one (N_anchors,)
        tensor per group drives the samplers. ``losses`` is empty
        without gt; with one group it is {loss_objectness,
        loss_rpn_box_reg}, with G groups those names with the suffix
        ``_{gi}``."""
        objectness, box_reg = self.head([m.feats for m in rpn_maps])
        anchors = generate_anchors(self.cfg, rpn_maps)
        g = self.head.groups
        proposals_g, losses = [], {}
        for gi in range(g):
            obj, reg = objectness[..., gi], box_reg[..., 7 * gi:7 * gi + 7]
            gt_gi = None if gt is None else gt[gi]
            proposals_g.append(select_proposals(
                self.cfg, anchors, obj, reg, gt_gi is not None, gt_gi))
            if gt_gi is None:
                continue
            lo, lb = rpn_loss(self.cfg, priorities[gi], anchors, obj, reg,
                              gt_gi)
            sfx = "" if g == 1 else f"_{gi}"
            losses[f"loss_objectness{sfx}"] = lo
            losses[f"loss_rpn_box_reg{sfx}"] = lb
        return proposals_g, losses
