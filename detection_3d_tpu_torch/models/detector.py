"""SparseRCNN: voxelize -> backbone -> RPN -> ROI head.

Counterpart of detection_3d_tpu/models/detector.py (reference
sparse_rcnn.py:18-77) for one building per call: detections without gt,
the training losses with gt (and, with ``cfg.eval_in_train``, the
train-time detections beside them). With separate-classifier groups
(``cfg.separate_classes``, models/separate_classifier.py) the RPN and the
ROI stage run once per group over one shared head and the groups'
detections merge in the original label space; with ``cfg.rpn_only`` the
model has no ROI head and the RPN's proposals are its detections.
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
from detection_3d_tpu_torch.models.separate_classifier import (
    grouped_class_ids, merge_group_detections, separate_targets,
    slice_group_logits,
)
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.ops.sparse import SparseTensor, build_sparse_tensor
from detection_3d_tpu_torch.utils.checkpoint import load_jax_checkpoint
from detection_3d_tpu_torch.utils.convert import convert_jax_params


def voxelize_points(cfg: Config, points_xyz, feats, valid,
                    capacity: Optional[int] = None) -> SparseTensor:
    """Continuous scaled coords -> deduplicated scale-0 voxel table: floor
    to int voxels and average the features of points sharing a voxel.
    ``capacity`` overrides the configured scale-0 table size (a spatial
    shard's own rows, parallel/spatial.py)."""
    coords = torch.floor(points_xyz).to(torch.int32)
    coords4 = torch.cat([coords, torch.zeros_like(coords[:, :1])], -1)
    if capacity is None:
        capacity = cfg.caps.scale_caps(cfg.sparse3d.num_scales)[0]
    return build_sparse_tensor(coords4, feats, valid,
                               cfg.sparse3d.voxel_full_scale, 1, capacity)


class SparseRCNN(nn.Module):
    """Backbone + RPN + ROI head (none with ``cfg.rpn_only``, as the JAX
    parameter tree has none). ``seed`` draws the initial weights from a
    ``torch.Generator`` (use :meth:`load_jax_params` to load a trained
    or JAX-initialised parameter tree instead)."""

    def __init__(self, cfg: Config, seed: int = 0):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.backbone = SparseFPN(cfg)
        self.rpn = RPN(cfg)
        if not cfg.rpn_only:
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

    @property
    def groups(self) -> int:
        """Proposal groups: cfg.group_num with a separate RPN, else 1."""
        return self.rpn.head.groups

    def priority_shapes(self) -> Dict[str, int]:
        """Lengths of the uniform draws a training forward takes, in the
        order the forward draws them from its generator: one per anchor
        for each group's RPN sampler, then (without ``rpn_only``) one per
        proposal (post-NMS top-n plus the gt rows) for each group's ROI
        sampler. One group: {"rpn", "roi"}; G groups: "rpn_0" ..
        "rpn_{G-1}", then "roi_0" .. "roi_{G-1}" (JAX draws them from
        ``fold_in(rng, gi)`` and ``fold_in(rng, 1000 + gi)``)."""
        cfg = self.cfg
        roi = cfg.rpn_post_nms_top_n_train + (
            cfg.caps.max_gt if cfg.rpn.add_gt_proposals else 0)
        kinds = [("rpn", num_anchors(cfg))]
        if not cfg.rpn_only:
            kinds.append(("roi", roi))
        return {key: n for kind, n in kinds
                for key in self._draw_keys(kind)}

    def _draw_keys(self, kind):
        g = self.groups
        return [kind] if g == 1 else [f"{kind}_{gi}" for gi in range(g)]

    def forward(self, table: SparseTensor, gt: Optional[Boxes3D] = None,
                gt_labels=None, *, generator=None, priorities=None,
                phases=None, pyramid=None):
        """One voxel table -> detections (fields scores, labels) without
        ``gt``; with ``gt`` (Boxes3D of max_gt rows) and ``gt_labels``,
        the loss dict, and with ``cfg.eval_in_train`` too, ``(losses,
        detections)``: the train-time detections postprocessed from the
        sampled rows that are not gt (JAX detector.py:124-136), outside
        the autograd graph. One group's losses are {loss_objectness,
        loss_rpn_box_reg, loss_classifier_roi, loss_box_reg_roi}; G
        groups give each name with the suffix ``_{gi}`` (4G losses);
        ``rpn_only`` gives the RPN's alone (JAX returns the proposals
        beside them). Detections of G groups are the groups' own
        (roi_detections_per_img rows each) concatenated, labels mapped
        back to the original ids; ``rpn_only`` detections are each
        group's proposals by objectness, label 1.

        The samplers draw uniform priorities from ``generator`` (a
        torch.Generator on the table's device) in the order of
        :meth:`priority_shapes`, unless ``priorities`` hands them in as
        a dict of tensors of those keys and lengths. ``phases``, when
        given, is a PhaseTimer (utils/timing.py) that times each stage.

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
        return self.heads(rpn_maps, roi_maps, gt, gt_labels,
                          priorities=priorities, phases=phases)

    def heads(self, rpn_maps, roi_maps, gt: Optional[Boxes3D] = None,
              gt_labels=None, *, priorities=None, phases=None):
        """Everything of :meth:`forward` after the backbone: the RPN and
        ROI stages on the backbone's maps, with :meth:`forward`'s
        results. Spatial sharding runs them replicated on the gathered
        global maps (parallel/spatial.py). With ``gt``, ``priorities``
        is the dict of the samplers' draws (:meth:`priority_shapes`)."""
        cfg = self.cfg
        timed = phases.phase if phases is not None else \
            (lambda name: contextlib.nullcontext())
        # group-wise gt (one group takes the gt as it is)
        if gt is None:
            gt_groups = None
        elif cfg.separate_classes:
            gt_groups = separate_targets(cfg, gt, gt_labels)
        else:
            gt_groups = [(gt, gt_labels)]
        with timed("rpn"):
            proposals_g, losses = self.rpn(
                rpn_maps, None if gt is None else [b for b, _ in gt_groups],
                None if gt is None else
                [priorities[k] for k in self._draw_keys("rpn")])
            proposals_g = [p.clamp_size() for p in proposals_g]
        if cfg.rpn_only:
            if gt is not None:
                return losses
            return self._merge([rpn_detections(p) for p in proposals_g])
        g = len(proposals_g)
        nc = [len(ids) for ids in grouped_class_ids(cfg)] if g > 1 else \
            [cfg.num_classes + len(cfg.separate_classes)]
        results = []
        if gt is not None:
            roi_pri = [priorities[k] for k in self._draw_keys("roi")]
            for gi, proposals in enumerate(proposals_g):
                gt_gi, labels_gi = gt_groups[gi]
                with timed("roi_head"):
                    sampled = subsample_proposals(cfg, roi_pri[gi], proposals,
                                                  gt_gi, labels_gi)
                    cls_logits, box_reg = self._head(roi_maps, sampled, gi)
                    cl, bl = roi_loss(cfg, sampled, cls_logits, box_reg)
                sfx = "" if g == 1 else f"_{gi}"
                losses[f"loss_classifier_roi{sfx}"] = cl
                losses[f"loss_box_reg_roi{sfx}"] = bl
                if not cfg.eval_in_train:
                    continue
                with torch.no_grad(), timed("postprocess"):
                    nogt = Boxes3D(
                        sampled.boxes.detach(),
                        sampled.valid & (sampled.fields["is_gt"] < 0.5))
                    results.append(postprocess(
                        cfg, nogt, cls_logits.detach(), box_reg.detach(),
                        nc[gi], cfg.roi_detections_per_img))
            if not cfg.eval_in_train:
                return losses
            with torch.no_grad():
                return losses, self._merge(results)
        for gi, proposals in enumerate(proposals_g):
            with timed("roi_head"):
                cls_logits, box_reg = self._head(roi_maps, proposals, gi)
            with timed("postprocess"):
                results.append(postprocess(cfg, proposals, cls_logits,
                                           box_reg, nc[gi],
                                           cfg.roi_detections_per_img))
        return self._merge(results)

    def _head(self, roi_maps, proposals: Boxes3D, gi: int):
        """The shared ROI head on ``proposals``, sliced to group gi's
        class columns when there are groups."""
        cls_logits, box_reg = self.roi_head(roi_maps, proposals)
        if self.groups > 1:
            cls_logits, box_reg = slice_group_logits(self.cfg, cls_logits,
                                                     box_reg, gi)
        return cls_logits, box_reg

    def _merge(self, results):
        return results[0] if len(results) == 1 else \
            merge_group_detections(self.cfg, results)


def rpn_detections(proposals: Boxes3D) -> Boxes3D:
    """An rpn_only model's detections of one group: its proposals in
    descending objectness, invalid rows last (a stable sort, as JAX's
    ``argsort(-score)``), scores = objectness, labels 1
    (rpn_sparse3d.py:294-305)."""
    obj = proposals.fields["objectness"]
    score = torch.where(proposals.valid, obj, float("-inf"))
    order = torch.sort(score, descending=True, stable=True).indices
    p = proposals.gather(order)
    p.fields["scores"] = p.fields["objectness"]
    p.fields["labels"] = torch.ones((p.capacity,), dtype=torch.int32,
                                    device=obj.device)
    return p
