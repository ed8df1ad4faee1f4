"""SparseRCNN, eval path: voxelize -> backbone -> RPN -> ROI head.

Counterpart of detection_3d_tpu/models/detector.py (reference
sparse_rcnn.py:18-77) for one building per call and one classifier
group. Training, separate-classifier groups and ``rpn_only`` are not
ported yet; the constructor rejects configs that ask for them.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.models.backbone import SparseFPN, build_pyramid
from detection_3d_tpu_torch.models.roi_head import ROIBoxHead, postprocess
from detection_3d_tpu_torch.models.rpn import RPN
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

    def forward(self, table: SparseTensor, phases=None) -> Boxes3D:
        """Eval forward of one voxel table -> detections (fields scores,
        labels). ``phases``, when given, is a PhaseTimer
        (utils/timing.py) that times each stage."""
        cfg = self.cfg
        timed = phases.phase if phases is not None else \
            (lambda name: contextlib.nullcontext())
        # feature compute in cfg.compute_dtype; geometry and box math f32
        table = table.with_feats(
            table.feats.to(getattr(torch, cfg.compute_dtype)))
        with timed("pyramid"):
            pyramid = build_pyramid(table, cfg)
        with timed("backbone"):
            rpn_maps, roi_maps = self.backbone(table, pyramid)
        with timed("rpn"):
            proposals = self.rpn(rpn_maps).clamp_size()
        with timed("roi_head"):
            cls_logits, box_reg = self.roi_head(roi_maps, proposals)
        with timed("postprocess"):
            return postprocess(cfg, proposals, cls_logits, box_reg,
                               cfg.num_classes, cfg.roi_detections_per_img)
