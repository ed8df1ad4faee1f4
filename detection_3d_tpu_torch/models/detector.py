"""SparseRCNN: voxelize -> backbone -> RPN -> ROI head.

Counterpart of detection_3d_tpu/models/detector.py (reference
sparse_rcnn.py:18-77) for one building per call and one classifier
group: detections without gt, the four training losses with gt (and,
with ``cfg.eval_in_train``, the train-time detections beside them).
Separate-classifier groups and ``rpn_only`` are not ported yet; the
model rejects configs that ask for them.
"""

from __future__ import annotations

import contextlib
import os
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
from detection_3d_tpu_torch.utils.checkpoint import load_jax_checkpoint
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
        ``SparseRCNN(cfg).init`` of the JAX package returns it), or the
        path of a ``.msgpack`` checkpoint of the JAX trainer, whose
        ``["params"]`` it loads."""
        if isinstance(params, (str, os.PathLike)):
            params = load_jax_checkpoint(params)["params"]
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
                phases=None, pyramid=None):
        """One voxel table -> detections (fields scores, labels) without
        ``gt``; with ``gt`` (Boxes3D of max_gt rows) and ``gt_labels``,
        the loss dict {loss_objectness, loss_rpn_box_reg,
        loss_classifier_roi, loss_box_reg_roi}, and with
        ``cfg.eval_in_train`` too, ``(losses, detections)``: the
        train-time detections postprocessed from the sampled rows that
        are not gt (JAX detector.py:124-136), outside the autograd graph.

        The two samplers draw uniform priorities from ``generator`` (a
        torch.Generator on the table's device), unless ``priorities``
        hands them in as {"rpn": (N_anchors,), "roi": (R,)} tensors
        (:meth:`priority_shapes`). ``phases``, when given, is a
        PhaseTimer (utils/timing.py) that times each stage.

        ``pyramid``, when given, is a host-built pyramid of ``table``
        (data/pyramid_packing.unpack_pyramid): the forward reads it
        instead of calling build_pyramid, with ``table`` (and its
        features) in place of its ``tables[0]``. A forward that takes a
        gradient needs its backward books (``unpack_pyramid(...,
        backward=True)``) and raises without them."""
        cfg = self.cfg
        timed = phases.phase if phases is not None else \
            (lambda name: contextlib.nullcontext())
        # feature compute in cfg.compute_dtype; geometry and box math f32
        table = table.with_feats(
            table.feats.to(getattr(torch, cfg.compute_dtype)))
        if gt is not None and priorities is None:
            priorities = {k: torch.rand((n,), generator=generator,
                                        device=table.device)
                          for k, n in self.priority_shapes().items()}
        # the backward books only where a gradient will be taken
        wants_grad = gt is not None and torch.is_grad_enabled()
        if pyramid is None:
            with timed("pyramid"):
                pyramid = build_pyramid(table, cfg, backward=wants_grad)
        elif wants_grad and "subm_bwd" not in pyramid:
            raise NotImplementedError(
                "a training forward on a host-packed pyramid needs its "
                "backward books: unpack it with unpack_pyramid(..., "
                "backward=True) from a pack made with backward=True")
        else:
            pyramid = dict(pyramid, tables=[table, *pyramid["tables"][1:]])
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
            if not cfg.eval_in_train:
                return losses
            with torch.no_grad(), timed("postprocess"):
                nogt = Boxes3D(sampled.boxes.detach(),
                               sampled.valid & (sampled.fields["is_gt"] < 0.5))
                return losses, postprocess(
                    cfg, nogt, cls_logits.detach(), box_reg.detach(),
                    cfg.num_classes, cfg.roi_detections_per_img)
        with timed("roi_head"):
            cls_logits, box_reg = self.roi_head(roi_maps, proposals)
        with timed("postprocess"):
            return postprocess(cfg, proposals, cls_logits, box_reg,
                               cfg.num_classes, cfg.roi_detections_per_img)
