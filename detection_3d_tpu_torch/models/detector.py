"""SparseRCNN: voxelize -> backbone -> RPN -> ROI head.

Counterpart of detection_3d_tpu/models/detector.py (reference
sparse_rcnn.py:18-77) for one building per call and one classifier
group: detections without gt, the four training losses with gt.
Separate-classifier groups, ``rpn_only`` and ``eval_in_train`` are not
ported yet; the model rejects configs that ask for them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.models.backbone import SparseFPN, build_pyramid
from detection_3d_tpu_torch.models.roi_head import (
    ROIBoxHead, postprocess, roi_loss, subsample_proposals,
)
from detection_3d_tpu_torch.models.rpn import RPN, num_anchors
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.ops.sparse import SparseTensor, build_sparse_tensor
from detection_3d_tpu_torch.utils.convert import convert_jax_params


def voxelize_points(cfg: Config, points_xyz, feats, valid) -> SparseTensor:
    """Continuous scaled coords -> deduplicated scale-0 voxel table: floor
    to int voxels and average the features of points sharing a voxel."""
    coords = torch.floor(points_xyz).to(torch.int32)
    coords4 = torch.cat([coords, torch.zeros_like(coords[:, :1])], -1)
    capacity = cfg.caps.scale_caps(cfg.sparse3d.num_scales)[0]
    return build_sparse_tensor(coords4, feats, valid,
                               cfg.sparse3d.voxel_full_scale, 1, capacity)


class SparseRCNN(nn.Module):
    """Backbone + RPN + ROI head. ``seed`` draws the initial weights
    from a ``torch.Generator`` (use :meth:`load_jax_params` to load a
    trained or JAX-initialised parameter tree instead)."""

    def __init__(self, cfg: Config, seed: int = 0):
        super().__init__()
        cfg.validate()
        if cfg.separate_classes or cfg.rpn_only:
            raise NotImplementedError(
                "the PyTorch port runs the single-group detector with an "
                "ROI head; separate_classes and rpn_only are not ported")
        self.cfg = cfg
        self.backbone = SparseFPN(cfg)
        self.rpn = RPN(cfg)
        self.roi_head = ROIBoxHead(cfg)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def load_jax_params(self, params):
        """Load a Flax parameter tree (nested dicts of numpy arrays, as
        ``SparseRCNN(cfg).init`` of the JAX package returns it)."""
        state = convert_jax_params(params)
        self.load_state_dict(state, strict=True)
        return self

    def priority_shapes(self) -> Dict[str, int]:
        """Lengths of the two uniform draws a training forward takes:
        one per anchor for the RPN sampler, one per proposal (post-NMS
        top-n plus the gt rows) for the ROI sampler."""
        cfg = self.cfg
        roi = cfg.rpn_post_nms_top_n_train + (
            cfg.caps.max_gt if cfg.rpn.add_gt_proposals else 0)
        return {"rpn": num_anchors(cfg), "roi": roi}

    def forward(self, table: SparseTensor, gt: Optional[Boxes3D] = None,
                gt_labels=None, *, generator=None, priorities=None,
                phases=None):
        """One voxel table -> detections (fields scores, labels) without
        ``gt``; with ``gt`` (Boxes3D of max_gt rows) and ``gt_labels``,
        the loss dict {loss_objectness, loss_rpn_box_reg,
        loss_classifier_roi, loss_box_reg_roi}.

        The two samplers draw uniform priorities from ``generator`` (a
        torch.Generator on the table's device), unless ``priorities``
        hands them in as {"rpn": (N_anchors,), "roi": (R,)} tensors
        (:meth:`priority_shapes`). ``phases``, when given, is a
        PhaseTimer (utils/timing.py) that times each stage."""
        cfg = self.cfg
        if gt is not None and cfg.eval_in_train:
            raise NotImplementedError(
                "eval_in_train waits for the evaluator, which the PyTorch "
                "port does not have yet")
        timed = phases.phase if phases is not None else \
            (lambda name: contextlib.nullcontext())
        # feature compute in cfg.compute_dtype; geometry and box math f32
        table = table.with_feats(
            table.feats.to(getattr(torch, cfg.compute_dtype)))
        if gt is not None and priorities is None:
            priorities = {k: torch.rand((n,), generator=generator,
                                        device=table.device)
                          for k, n in self.priority_shapes().items()}
        with timed("pyramid"):
            pyramid = build_pyramid(table, cfg)
        with timed("backbone"):
            rpn_maps, roi_maps = self.backbone(table, pyramid)
        with timed("rpn"):
            proposals, losses = self.rpn(
                rpn_maps, gt, None if gt is None else priorities["rpn"])
            proposals = proposals.clamp_size()
        if gt is not None:
            with timed("roi_head"):
                sampled = subsample_proposals(cfg, priorities["roi"],
                                              proposals, gt, gt_labels)
                cls_logits, box_reg = self.roi_head(roi_maps, sampled)
                cl, bl = roi_loss(cfg, sampled, cls_logits, box_reg)
            losses["loss_classifier_roi"] = cl
            losses["loss_box_reg_roi"] = bl
            return losses
        with timed("roi_head"):
            cls_logits, box_reg = self.roi_head(roi_maps, proposals)
        with timed("postprocess"):
            return postprocess(cfg, proposals, cls_logits, box_reg,
                               cfg.num_classes, cfg.roi_detections_per_img)
