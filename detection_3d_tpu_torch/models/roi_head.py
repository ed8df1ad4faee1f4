"""ROI box head: level mapping, rotated pooling, MLP head, targets and
loss, post-processing.

Counterpart of detection_3d_tpu/models/roi_head.py:
  * LevelMapper_3d: size = sqrt(max(y_size, x_size)), rate = size /
    canonical, level = argmin |spatial_scale - rate|;
  * all FPN levels pool in ONE roi_align pass over a merged table whose
    batch axis is the level;
  * extractor: conv3d [1,1,os2] (one matmul) + BN + ReLU, fc6, fc7;
  * predictor: linear cls + 7*C box regression;
  * targets and loss (box_head_3d/loss.py:22-237): matcher FG = BG =
    0.5 without low-quality rescue, a balanced sample, CE + per-class
    smooth-L1 (beta 1/5) over positives / the sampled count;
  * postprocess: softmax, per-class score threshold + rotated NMS, then
    the global top detections by score.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.models.losses import (
    cross_entropy, smooth_l1_box_loss,
)
from detection_3d_tpu_torch.models.matcher import (
    BETWEEN, balanced_sample, match_boxes,
)
from detection_3d_tpu_torch.models.rpn import top_k
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.ops.box_coder import BoxCoder3D
from detection_3d_tpu_torch.ops.geometry import yx_zb_to_standard
from detection_3d_tpu_torch.ops.nms import nms_boxes
from detection_3d_tpu_torch.ops.norm import batch_norm_leaky_relu
from detection_3d_tpu_torch.ops.roi_align import roi_align_rotated_sparse
from detection_3d_tpu_torch.ops.rotated_iou import boxes_iou_3d
from detection_3d_tpu_torch.ops.sparse import (
    SparseTensor, build_sparse_tensor,
)


def map_levels(cfg: Config, boxes):
    """(R,) level index per roi (first level on ties, as jnp.argmin)."""
    scales = torch.tensor(cfg.roi_spatial_scales(), dtype=torch.float32,
                          device=boxes.device)
    size = torch.sqrt(torch.maximum(boxes[:, 3], boxes[:, 4]))
    rate = size / cfg.roi.canonical_size
    return torch.argmin(torch.abs(scales[None, :] - rate[:, None]), dim=1)


def merge_roi_levels(roi_maps: Sequence[SparseTensor]) -> SparseTensor:
    """Stack all FPN roi levels into ONE table whose batch axis is the
    level index, so a single roi_align pass serves every level."""
    if len(roi_maps) == 1:
        return roi_maps[0]
    X = max(t.spatial_size[0] for t in roi_maps)
    Y = max(t.spatial_size[1] for t in roi_maps)
    Z = max(t.spatial_size[2] for t in roi_maps)
    coords = []
    for li, t in enumerate(roi_maps):
        c = t.coords.clone()
        c[:, 3] = li
        coords.append(c)
    coords = torch.cat(coords, 0)
    feats = torch.cat([t.feats for t in roi_maps], 0)
    valid = torch.cat([t.row_valid for t in roi_maps], 0)
    cap = sum(t.capacity for t in roi_maps)
    return build_sparse_tensor(coords, feats, valid, (X, Y, Z),
                               len(roi_maps), cap, reduce="sum")


def pool_rois(cfg: Config, roi_maps: Sequence[SparseTensor],
              proposals: Boxes3D):
    """(R, os0, os1, os2, C) pooled features: yx_zb proposals in meters,
    each pooled at its level's voxel scale."""
    os = cfg.roi.pooler_resolution
    sr = cfg.roi.pooler_sampling_ratio
    levels = map_levels(cfg, proposals.boxes)
    std = yx_zb_to_standard(proposals.boxes)
    vs = float(cfg.sparse3d.voxel_scale)
    merged = merge_roi_levels(roi_maps)
    factors = vs * torch.tensor(cfg.roi_spatial_scales(), dtype=std.dtype,
                                device=std.device)
    f = factors[levels][:, None]
    rois = torch.cat([std[:, :6] * f, std[:, 6:7]], -1)
    roi_batch = levels if len(roi_maps) > 1 else None
    return roi_align_rotated_sparse(merged, rois, proposals.valid, os, sr,
                                    roi_batch=roi_batch)


class ROIBoxFeatureExtractor(nn.Module):
    """conv3d [1,1,z] + BN + ReLU -> fc6 -> fc7 (both mlp_head_dim, ReLU)."""

    def __init__(self, cfg: Config):
        super().__init__()
        os0, os1, os2 = cfg.roi.pooler_resolution
        c = cfg.sparse3d.nplane_map
        rep = cfg.roi.mlp_head_dim
        self.conv3d_w = nn.Parameter(torch.empty(os2 * c, rep))
        self.conv3d_b = nn.Parameter(torch.zeros(rep))
        self.bn_scale = nn.Parameter(torch.ones(rep))
        self.bn_bias = nn.Parameter(torch.zeros(rep))
        self.fc6_w = nn.Parameter(torch.empty(os0 * os1 * rep, rep))
        self.fc6_b = nn.Parameter(torch.zeros(rep))
        self.fc7_w = nn.Parameter(torch.empty(rep, rep))
        self.fc7_b = nn.Parameter(torch.zeros(rep))

    def reset_parameters(self, gen):
        """Flax's he_normal (truncated normal, fan-in) for the conv,
        kaiming_uniform (fan-in) for the fc layers."""
        with torch.no_grad():
            # flax variance_scaling truncates at 2 std and rescales the
            # std by 1/0.8796... so the truncated variance is 2 / fan_in
            std = math.sqrt(2.0 / self.conv3d_w.shape[0]) / 0.87962566103423978
            nn.init.trunc_normal_(self.conv3d_w, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=gen)
            for fc in (self.fc6_w, self.fc7_w):
                bound = math.sqrt(6.0 / fc.shape[0])
                fc.uniform_(-bound, bound, generator=gen)
            for b in (self.conv3d_b, self.bn_bias, self.fc6_b, self.fc7_b):
                b.zero_()
            self.bn_scale.fill_(1.0)

    def forward(self, pooled, roi_valid):
        r, os0, os1, os2, c = pooled.shape
        rep = self.conv3d_w.shape[1]
        dt = pooled.dtype
        h = pooled.reshape(r, os0, os1, os2 * c) @ self.conv3d_w.to(dt) \
            + self.conv3d_b.to(dt)
        flat = h.reshape(r * os0 * os1, rep)
        vmask = torch.repeat_interleave(roi_valid, os0 * os1)
        flat = batch_norm_leaky_relu(flat, vmask, self.bn_scale,
                                     self.bn_bias)
        h = flat.reshape(r, os0 * os1 * rep)
        h = torch.relu(h @ self.fc6_w.to(dt) + self.fc6_b.to(dt))
        h = torch.relu(h @ self.fc7_w.to(dt) + self.fc7_b.to(dt))
        return torch.where(roi_valid[:, None], h, 0.0)


class ROIPredictor(nn.Module):
    """FPNPredictor: cls (std 0.01) + per-class box regression (0.001)."""

    def __init__(self, cfg: Config):
        super().__init__()
        nc = cfg.num_classes + len(cfg.separate_classes)
        rep = cfg.roi.mlp_head_dim
        self.cls_w = nn.Parameter(torch.empty(rep, nc))
        self.cls_b = nn.Parameter(torch.zeros(nc))
        self.box_w = nn.Parameter(torch.empty(rep, nc * 7))
        self.box_b = nn.Parameter(torch.zeros(nc * 7))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.cls_w.normal_(0.0, 0.01, generator=gen)
            self.box_w.normal_(0.0, 0.001, generator=gen)
            self.cls_b.zero_()
            self.box_b.zero_()

    def forward(self, x):
        dt = x.dtype
        cls = (x @ self.cls_w.to(dt) + self.cls_b.to(dt)).to(torch.float32)
        box = (x @ self.box_w.to(dt) + self.box_b.to(dt)).to(torch.float32)
        return cls, box


def roi_targets(cfg: Config, proposals: Boxes3D, gt: Boxes3D, gt_labels):
    """Per-proposal class label (0 background, -1 ignore) and regression
    target (box_head_3d/loss.py:47-118): IoU criterion -1 with the
    label-generation thickness floors."""
    aug = {"target_Y": cfg.roi.label_aug_thickness_y_tar_anc[0],
           "anchor_Y": cfg.roi.label_aug_thickness_y_tar_anc[1],
           "target_Z": cfg.roi.label_aug_thickness_z_tar_anc[0],
           "anchor_Z": cfg.roi.label_aug_thickness_z_tar_anc[1]}
    quality = boxes_iou_3d(gt.boxes, proposals.boxes, aug_thickness=aug,
                           criterion=-1)
    matches = match_boxes(quality, gt.valid, proposals.valid,
                          high=cfg.roi.fg_iou_threshold,
                          low=cfg.roi.bg_iou_threshold,
                          allow_low_quality=False)
    safe = torch.clamp(matches, min=0).to(torch.int64)
    labels = gt_labels[safe].to(torch.int32)
    labels = torch.where(matches == -1, 0, labels)
    labels = torch.where(matches == BETWEEN, -1, labels)
    labels = torch.where(proposals.valid, labels, -1)
    coder = BoxCoder3D(weights=cfg.roi.bbox_reg_weights)
    return labels, coder.encode(gt.boxes[safe], proposals.boxes)


def subsample_proposals(cfg: Config, priorities, proposals: Boxes3D,
                        gt: Boxes3D, gt_labels) -> Boxes3D:
    """Balanced sample of the proposals, gathered into a static set of
    roi_batch_size_per_image rows with the fields labels,
    regression_targets and is_gt (box_head_3d/loss.py:121-166).

    ``priorities`` (R,) serves the sampler AND breaks the ties of the
    gather order, as in the JAX package, where both draw
    ``jax.random.uniform`` from one key at one shape."""
    labels, reg_targets = roi_targets(cfg, proposals, gt, gt_labels)
    pos_mask, neg_mask = balanced_sample(
        labels, priorities, cfg.roi_batch_size_per_image,
        cfg.roi.positive_fraction)
    sampled = pos_mask | neg_mask
    pri = torch.where(sampled, 1.0, 0.0) + priorities * 0.5
    _, idx = top_k(pri, cfg.roi_batch_size_per_image)
    is_gt = proposals.fields.get(
        "is_gt", torch.zeros(labels.shape, device=labels.device))
    out = Boxes3D(proposals.boxes, proposals.valid & sampled,
                  {"labels": labels, "regression_targets": reg_targets,
                   "is_gt": is_gt})
    return out.gather(idx)


def roi_loss(cfg: Config, sampled: Boxes3D, class_logits, box_regression):
    """(loss_classifier_roi, loss_box_reg_roi): CE over the sampled rows
    and the smooth-L1 of each positive row's own class slot
    (box_head_3d/loss.py:196-237)."""
    labels = sampled.fields["labels"]
    valid = sampled.valid & (labels >= 0)
    cls_loss = cross_entropy(class_logits, labels, valid)
    pos = valid & (labels > 0)
    reg = box_regression.reshape(box_regression.shape[0], -1, 7)
    slot = torch.clamp(labels, min=0).to(torch.int64)[:, None, None]
    reg_pos = torch.gather(reg, 1, slot.expand(-1, 1, 7))[:, 0]
    n_sampled = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    box_l = smooth_l1_box_loss(
        reg_pos, sampled.fields["regression_targets"], sampled.boxes, pos,
        beta=1.0 / 5, yaw_loss_mode=cfg.rpn.yaw_loss_mode) / n_sampled
    return cls_loss, box_l


def postprocess(cfg: Config, proposals: Boxes3D, class_logits,
                box_regression, num_classes: int, detections_cap: int):
    """Per-class score threshold -> per-class rotated NMS -> global top-K.
    Static output: (detections_cap,) rows; fields scores, labels."""
    probs = torch.softmax(class_logits, dim=-1)
    coder = BoxCoder3D(weights=cfg.roi.bbox_reg_weights)
    r = box_regression.shape[0]
    dec = coder.decode(box_regression, proposals.boxes).reshape(
        r, num_classes, 7)
    ay, az = cfg.roi.nms_aug_thickness_y_z
    post_cap = min(cfg.roi.nms_post_cap, r)

    boxes, scores, labels, valid = [], [], [], []
    for j in range(1, num_classes):      # foreground classes
        boxes_j, scores_j = dec[:, j], probs[:, j]
        valid_j = proposals.valid & (scores_j > cfg.roi.score_thresh)
        nms_in = boxes_j.clone()
        nms_in[:, 3:5] = torch.clamp(nms_in[:, 3:5], min=ay)
        nms_in[:, 5] = torch.clamp(nms_in[:, 5], min=az)
        keep_idx, _ = nms_boxes(nms_in, scores_j, valid_j, cfg.roi.nms,
                                post_cap)
        kept = Boxes3D(boxes_j, valid_j,
                       {"scores": scores_j}).gather(keep_idx)
        boxes.append(kept.boxes)
        scores.append(kept.fields["scores"])
        valid.append(kept.valid)
        labels.append(torch.full((post_cap,), j, dtype=torch.int32,
                                 device=dec.device))
    boxes, scores = torch.cat(boxes, 0), torch.cat(scores, 0)
    labels, valid = torch.cat(labels, 0), torch.cat(valid, 0)

    pri = torch.where(valid, scores, -1.0)
    top_scores, idx = top_k(pri, min(detections_cap, pri.shape[0]))
    return Boxes3D(boxes[idx], valid[idx] & (top_scores >= 0),
                   {"scores": scores[idx], "labels": labels[idx]})


class ROIBoxHead(nn.Module):
    """Feature extractor + predictor for one forward."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.extractor = ROIBoxFeatureExtractor(cfg)
        self.predictor = ROIPredictor(cfg)

    def forward(self, roi_maps, proposals: Boxes3D):
        pooled = pool_rois(self.cfg, roi_maps, proposals)
        return self.predictor(self.extractor(pooled, proposals.valid))
