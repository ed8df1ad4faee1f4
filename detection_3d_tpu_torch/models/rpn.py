"""RPN, eval path: head, anchors, top-k, decode, rotated NMS.

Counterpart of detection_3d_tpu/models/rpn.py (reference
rpn_sparse3d.py:80-131 for the head, rpn/inference_3d.py:82-163 for
proposal selection). Target assignment and losses belong to training,
which this package does not port yet.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.models.anchors import generate_anchors
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.ops.box_coder import BoxCoder3D
from detection_3d_tpu_torch.ops.nms import nms_boxes
from detection_3d_tpu_torch.ops.sparse import SparseTensor


def top_k(values, k: int):
    """(values, indices) of the k largest entries, ties lowest index
    first — the order of ``jax.lax.top_k`` (``torch.topk`` promises no
    order among ties)."""
    out = torch.sort(values, descending=True, stable=True)
    return out.values[:k], out.indices[:k]


class RPNHead(nn.Module):
    """Shared 1x1 conv + ReLU, then 1x1 cls (A logits) and box (A*7)
    heads; weights shared across levels (init std 0.01). One classifier
    group: separate-classifier groups are not ported."""

    def __init__(self, cfg: Config):
        super().__init__()
        a = cfg.rpn.num_anchors_per_location
        c = cfg.sparse3d.nplane_map
        self.conv_w = nn.Parameter(torch.empty(c, c))
        self.conv_b = nn.Parameter(torch.zeros(c))
        self.cls_w = nn.Parameter(torch.empty(c, a))
        self.cls_b = nn.Parameter(torch.zeros(a))
        self.box_w = nn.Parameter(torch.empty(c, a * 7))
        self.box_b = nn.Parameter(torch.zeros(a * 7))

    def reset_parameters(self, gen):
        with torch.no_grad():
            for w in (self.conv_w, self.cls_w, self.box_w):
                w.normal_(0.0, 0.01, generator=gen)
            for b in (self.conv_b, self.cls_b, self.box_b):
                b.zero_()

    def forward(self, feats_per_level):
        logits, regs = [], []
        for f in feats_per_level:
            dt = f.dtype
            t = torch.relu(f @ self.conv_w.to(dt) + self.conv_b.to(dt))
            lg = t @ self.cls_w.to(dt) + self.cls_b.to(dt)
            rg = t @ self.box_w.to(dt) + self.box_b.to(dt)
            # box/score math downstream is f32
            logits.append(lg.reshape(-1).to(torch.float32))
            regs.append(rg.reshape(-1, 7).to(torch.float32))
        return torch.cat(logits, 0), torch.cat(regs, 0)


def select_proposals(cfg: Config, anchors: Boxes3D, objectness, box_reg):
    """Eval branch: sigmoid -> top-k (pre-NMS) -> decode -> rotated NMS
    -> top post-NMS. Returns Boxes3D with the field objectness."""
    pre_n = min(cfg.rpn_pre_nms_top_n_test, objectness.shape[0])
    post_n = cfg.rpn_post_nms_top_n_test
    score = torch.where(anchors.valid, torch.sigmoid(objectness), -1.0)
    top_score, top_idx = top_k(score, pre_n)
    top_valid = top_score >= 0.0
    dec = BoxCoder3D().decode(box_reg[top_idx], anchors.boxes[top_idx])

    # NMS with thickness augmentation on y/x sizes and z
    ay, az = cfg.rpn.nms_aug_thickness_y_z
    nms_in = dec.clone()
    nms_in[:, 3:5] = torch.clamp(nms_in[:, 3:5], min=ay)
    nms_in[:, 5] = torch.clamp(nms_in[:, 5], min=az)
    keep_idx, _ = nms_boxes(nms_in, top_score, top_valid, cfg.rpn.nms_thresh,
                            post_n)
    return Boxes3D(dec, top_valid, {"objectness": top_score}).gather(keep_idx)


class RPN(nn.Module):
    """Head + anchors + proposal selection (one classifier group)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.head = RPNHead(cfg)

    def forward(self, rpn_maps: List[SparseTensor]):
        objectness, box_reg = self.head([m.feats for m in rpn_maps])
        anchors = generate_anchors(self.cfg, rpn_maps)
        return select_proposals(self.cfg, anchors, objectness, box_reg)
