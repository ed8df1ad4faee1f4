"""Yaw conventions, box-format conversions and rotated-rectangle corners.

Counterpart of detection_3d_tpu/ops/geometry.py (reference:
utils3d/geometric_torch.py, utils3d/bbox3d_ops.py):
    standard: [xc, yc, zc,    x_size, y_size, z_size, yaw]
    yx_zb   : [xc, yc, z_bot, y_size, x_size, z_size, yaw - pi/2]
Functions work on (..., 7) float tensors; :func:`box3d_corners` gives a
standard box's 8 corners.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def limit_period(val, offset: float, period: float):
    """Wrap ``val`` into a period-sized scope.

    [0, pi]: offset=0, period=pi;  [-pi/2, pi/2]: offset=0.5, period=pi.
    """
    return val - torch.floor(val / period + offset) * period


def limit_yaw(yaws, yx_zb: bool):
    """standard: [0, pi];  yx_zb: [-pi/2, pi/2]."""
    if yx_zb:
        return limit_period(yaws, 0.5, PI)
    return limit_period(yaws, 0.0, PI)


def yx_zb_to_standard(boxes):
    """yx_zb ``[xc,yc,z_bot,y_size,x_size,z_size,yaw]`` -> standard."""
    xc, yc, zb, ys, xs, zs, yaw = boxes.split(1, dim=-1)
    zc = zb + zs * 0.5
    yaw = limit_yaw(yaw + PI * 0.5, yx_zb=False)
    return torch.cat([xc, yc, zc, xs, ys, zs, yaw], dim=-1)


def standard_to_yx_zb(boxes):
    """standard -> yx_zb."""
    xc, yc, zc, xs, ys, zs, yaw = boxes.split(1, dim=-1)
    zb = zc - zs * 0.5
    yaw = limit_yaw(yaw - PI * 0.5, yx_zb=True)
    return torch.cat([xc, yc, zb, ys, xs, zs, yaw], dim=-1)


def rbbox_corners_2d(rbbox):
    """Corners of rotated 2D rects: (..., 5) [cx, cy, x_d, y_d, angle] ->
    (..., 4, 2). Local corners ((-x/2,-y/2), (-x/2,y/2), (x/2,y/2),
    (x/2,-y/2)) mapped by [[cos, sin], [-sin, cos]]."""
    cx, cy, xd, yd, ang = rbbox.unbind(-1)
    c, s = torch.cos(ang), torch.sin(ang)
    hx, hy = xd * 0.5, yd * 0.5
    lx = torch.stack([-hx, -hx, hx, hx], dim=-1)
    ly = torch.stack([-hy, hy, hy, -hy], dim=-1)
    wx = c[..., None] * lx + s[..., None] * ly + cx[..., None]
    wy = -s[..., None] * lx + c[..., None] * ly + cy[..., None]
    return torch.stack([wx, wy], dim=-1)


def box3d_corners(boxes_standard):
    """8 corners of standard-format 3D boxes: (..., 7) -> (..., 8, 3),
    the z-low face first (xy order 00, 10, 01, 11), then the z-high face
    (utils3d/bbox3d_ops.py:101-102, Bbox3D._corners_tmp)."""
    xc, yc, zc, xs, ys, zs, yaw = boxes_standard.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    sx = torch.tensor([-0.5, 0.5, -0.5, 0.5], dtype=boxes_standard.dtype,
                      device=boxes_standard.device)
    sy = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=boxes_standard.dtype,
                      device=boxes_standard.device)
    lx = sx * xs[..., None]
    ly = sy * ys[..., None]
    wx = c[..., None] * lx + s[..., None] * ly + xc[..., None]
    wy = -s[..., None] * lx + c[..., None] * ly + yc[..., None]
    zlo = (zc - 0.5 * zs)[..., None] * torch.ones_like(sx)
    zhi = (zc + 0.5 * zs)[..., None] * torch.ones_like(sx)
    low = torch.stack([wx, wy, zlo], dim=-1)
    high = torch.stack([wx, wy, zhi], dim=-1)
    return torch.cat([low, high], dim=-2)
