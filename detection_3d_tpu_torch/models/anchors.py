"""Sparse-site anchor generation.

Counterpart of detection_3d_tpu/models/anchors.py: anchors exist only at
active feature-map voxels. Per level, integer site coords scale by
(anchor_stride / voxel_scale) to meters and broadcast-add the level's
cell anchors; flatten order is [level, location, anchor].
"""

from __future__ import annotations

import numpy as np
import torch

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.models.structures import Boxes3D


def cell_anchors(cfg: Config):
    """Per-level (A, 7) numpy cell anchors; A = len(yaws) == len(ratios).
    ANCHOR_SIZES_3D entries are (y, x, z) sizes; z is the box bottom."""
    out = []
    for size, use_yaw in zip(cfg.rpn.anchor_sizes_3d, cfg.rpn.use_yaws):
        rows = []
        if use_yaw:
            for yaw in cfg.rpn.yaws:
                rows.append([0, 0, 0, size[0], size[1], size[2], yaw])
        else:
            for ratio in cfg.rpn.ratios:
                rows.append([0, 0, 0, size[0] * ratio[0], size[1] * ratio[1],
                             size[2] * ratio[2], 0.0])
        out.append(np.array(rows, np.float32))
    return out


def generate_anchors(cfg: Config, rpn_maps) -> Boxes3D:
    """All-level anchors of one example, validity from each table's rows."""
    cells = cell_anchors(cfg)
    strides = cfg.anchor_strides()
    vs = float(cfg.sparse3d.voxel_scale)
    a = cfg.rpn.num_anchors_per_location
    all_boxes, all_valid = [], []
    for lvl, table in enumerate(rpn_maps):
        dev = table.device
        stride = torch.tensor(strides[lvl], dtype=torch.float32, device=dev)
        centers = table.coords[:, :3].to(torch.float32) * stride / vs
        cent7 = torch.cat([centers, centers.new_zeros((centers.shape[0], 4))],
                          -1)
        base = torch.from_numpy(cells[lvl]).to(dev)
        boxes = cent7[:, None, :] + base[None, :, :]
        all_boxes.append(boxes.reshape(-1, 7))
        all_valid.append(torch.repeat_interleave(table.row_valid, a))
    return Boxes3D(torch.cat(all_boxes, 0), torch.cat(all_valid, 0))
