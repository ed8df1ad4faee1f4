"""Per-point labels of a generated building, from its gt boxes: a point
takes the label of the smallest box that holds it, each box grown by
half a voxel on every side, and -1 (ignored) where no box holds it. The
generator (synthetic.py) draws every point on a box's faces with 4 mm of
noise, so at 2 cm voxels (``voxel_scale`` 50, the generator's) each
point lies in its own box once grown; where boxes meet (a door in its
wall, a wall on the floor) the smaller one, the finer part, wins.

One torch function over the points, run in float32 where they are;
:func:`label_scene` labels a building of the pool once, at set-up
(windows/labelled_train.py), and the program and the reference both read
those labels. Ties of volume go to the first box.
"""

from __future__ import annotations

import math

import numpy as np
import torch

VOXEL_SCALE = 50     # the generator's: points are in voxels of 2 cm
CHUNK = 1 << 16      # points a pass, (CHUNK, boxes) temporaries


def label_points(points, points_valid, gt_boxes, gt_labels, gt_valid,
                 voxel_scale: int = VOXEL_SCALE):
    """(P,) int32 labels of (P, 3) points in voxel units, from (M, 7)
    yx_zb boxes in meters [xc, yc, z_bottom, y size, x size, z size,
    yaw - pi/2] with their (M,) labels; invalid points and boxes take no
    part."""
    grow = 0.5 / voxel_scale
    xc, yc, zb, ys, xs, zs, yaw = gt_boxes.to(torch.float32).unbind(-1)
    c, s = torch.cos(yaw + math.pi / 2), torch.sin(yaw + math.pi / 2)
    zc = zb + zs / 2
    vol = torch.where(gt_valid, xs * ys * zs, torch.inf)
    out = []
    for p in (points.to(torch.float32) / voxel_scale).split(CHUNK):
        dx, dy = p[:, :1] - xc, p[:, 1:2] - yc
        inside = (((c * dx - s * dy).abs() <= xs / 2 + grow)
                  & ((s * dx + c * dy).abs() <= ys / 2 + grow)
                  & ((p[:, 2:] - zc).abs() <= zs / 2 + grow) & gt_valid)
        best = torch.where(inside, vol, torch.inf).argmin(1)
        out.append(torch.where(inside.any(1), gt_labels[best].to(torch.int32),
                               -1))
    labels = torch.cat(out) if out else \
        points.new_zeros((0,), dtype=torch.int32)
    return torch.where(points_valid, labels, -1).to(torch.int32)


def label_scene(scene, device) -> np.ndarray:
    """(N,) int32 labels of a pool building's points (:func:`label_points`
    over all its points and boxes), computed on ``device``."""
    pts = torch.as_tensor(scene["points"], device=device)
    n, m = pts.shape[0], scene["gt_boxes"].shape[0]
    if m == 0:
        return np.full((n,), -1, np.int32)
    out = label_points(
        pts, torch.ones((n,), dtype=torch.bool, device=device),
        torch.as_tensor(scene["gt_boxes"], device=device),
        torch.as_tensor(scene["gt_labels"], device=device),
        torch.ones((m,), dtype=torch.bool, device=device))
    return out.cpu().numpy()
