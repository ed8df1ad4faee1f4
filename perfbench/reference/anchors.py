"""Sparse-site anchor generation.

Counterpart of detection_3d_tpu/models/anchors.py: anchors exist only at
active feature-map voxels. Per level, integer site coords scale by
(anchor_stride / voxel_scale) to meters and broadcast-add the level's
cell anchors; flatten order is [level, location, anchor].
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.config import Config
from perfbench.reference.structures import Boxes3D
from perfbench.reference.device import device_constant


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
    """All-level anchors of one example, validity from each table's rows;
    a unit's maps give (B, A, 7) anchors, each building's at its own
    sites."""
    cells = cell_anchors(cfg)
    strides = cfg.anchor_strides()
    vs = float(cfg.sparse3d.voxel_scale)
    a = cfg.rpn.num_anchors_per_location
    all_boxes, all_valid = [], []
    for lvl, table in enumerate(rpn_maps):
        dev = table.device
        stride = device_constant(tuple(strides[lvl]), torch.float32, dev)
        centers = table.coords[..., :3].to(torch.float32) * stride / vs
        cent7 = torch.cat([centers, centers.new_zeros(centers.shape[:-1]
                                                      + (4,))], -1)
        base = device_constant(tuple(map(tuple, cells[lvl].tolist())),
                               torch.float32, dev)
        boxes = cent7[..., :, None, :] + base
        lead = boxes.shape[:-3]
        all_boxes.append(boxes.reshape(lead + (-1, 7)))
        rv = table.row_valid
        all_valid.append(rv[..., None].expand(rv.shape + (a,))
                         .reshape(lead + (-1,)))
    return Boxes3D(torch.cat(all_boxes, -2), torch.cat(all_valid, -1))
