"""SECOND/VoxelNet 7-DoF box codec.

Counterpart of detection_3d_tpu/ops/box_coder.py (reference:
second/pytorch/core/box_torch_ops.py:15-88 and
maskrcnn_benchmark/modeling/box_coder_3d.py:8-65). The reference always
runs ``smooth_dim=True``: sizes encoded linearly (size / anchor - 1) and
clipped at 10000 when decoded; ``smooth_dim=False`` is SECOND's log form
(log(size / anchor), clipped at log(1000)). Boxes and anchors are yx_zb
``[xc, yc, z_bot, y_size, x_size, z_size, yaw]``; w=y_size, l=x_size,
h=z_size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from perfbench.reference.geometry import limit_period
from perfbench.reference.device import device_constant


def second_box_encode(boxes, anchors, smooth_dim: bool = True):
    """(..., 7) targets vs (..., 7) anchors -> (..., 7) regression deltas."""
    xa, ya, za, wa, la, ha, ra = anchors.split(1, dim=-1)
    xg, yg, zg, wg, lg, hg, rg = boxes.split(1, dim=-1)
    diagonal = torch.sqrt(la * la + wa * wa)
    xt = (xg - xa) / diagonal
    yt = (yg - ya) / diagonal
    zt = (zg - za) / ha
    if smooth_dim:
        lt = lg / la - 1.0
        wt = wg / wa - 1.0
        ht = hg / ha - 1.0
    else:
        lt = torch.log(lg / la)
        wt = torch.log(wg / wa)
        ht = torch.log(hg / ha)
    rt = rg - ra
    return torch.cat([xt, yt, zt, wt, lt, ht, rt], dim=-1)


def second_box_decode(encodings, anchors, smooth_dim: bool = True):
    """Inverse of :func:`second_box_encode`."""
    xa, ya, za, wa, la, ha, ra = anchors.split(1, dim=-1)
    xt, yt, zt, wt, lt, ht, rt = encodings.split(1, dim=-1)
    diagonal = torch.sqrt(la * la + wa * wa)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    if smooth_dim:
        lg = (lt + 1.0) * la
        wg = (wt + 1.0) * wa
        hg = (ht + 1.0) * ha
    else:
        lg = torch.exp(lt) * la
        wg = torch.exp(wt) * wa
        hg = torch.exp(ht) * ha
    rg = rt + ra
    return torch.cat([xg, yg, zg, wg, lg, hg, rg], dim=-1)


@dataclass(frozen=True)
class BoxCoder3D:
    """Encode/decode with per-column weights, yaw wrapped to
    [-pi/2, pi/2] and sizes clipped."""

    weights: tuple = field(default=(1.0,) * 7)
    smooth_dim: bool = True

    @property
    def bbox_xform_clip(self) -> float:
        return 10000.0 if self.smooth_dim else math.log(1000.0)

    def encode(self, targets, anchors):
        w = device_constant(tuple(self.weights), targets.dtype,
                            targets.device)
        enc = second_box_encode(targets, anchors, self.smooth_dim)
        yaw = limit_period(enc[..., -1:], 0.5, math.pi)
        return torch.cat([enc[..., :-1], yaw], dim=-1) * w

    def decode(self, encodings, anchors):
        """``encodings``: (N, 7*C); ``anchors``: (N, 7). Returns (N, 7*C):
        each anchor is tiled across its C class slots."""
        num_classes = encodings.shape[-1] // 7
        lead = encodings.shape[:-1]
        enc = encodings.reshape(lead + (num_classes, 7))
        anc = anchors[..., None, :].expand(lead + (num_classes, 7))

        w = device_constant(tuple(self.weights), enc.dtype, enc.device)
        enc = enc / w
        sizes = torch.clamp(enc[..., 3:6], max=self.bbox_xform_clip)
        enc = torch.cat([enc[..., :3], sizes, enc[..., 6:]], dim=-1)
        dec = second_box_decode(enc, anc, self.smooth_dim)
        yaw = limit_period(dec[..., -1:], 0.5, math.pi)
        dec = torch.cat([dec[..., :-1], yaw], dim=-1)
        return dec.reshape(lead + (num_classes * 7,))
