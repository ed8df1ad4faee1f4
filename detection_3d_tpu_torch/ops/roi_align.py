"""Rotated 3D ROI align by sparse lookup — no dense feature volume.

Counterpart of detection_3d_tpu/ops/roi_align.py (reference
ROIAlignRotated3D_cuda.cu:88-177 on a SparseToDense volume): sample
points are generated per bin, their 8 trilinear corner voxels are looked
up in the sorted sparse table (missing voxels read zero, as the dense
volume's zeros), and the weighted corner features are summed.

Sampling: ``sampling_ratio`` samples per bin axis at bin-relative offsets
(i + 0.5) / ratio, averaged; local offsets start at -size/2; ROI sizes
are floored at 1 voxel; trilinear weights use floor(coord) clamped to
the grid; world = [[cos, -sin], [sin, cos]] @ local + center with the
standard-format yaw.
"""

from __future__ import annotations

from typing import Tuple

import torch

from detection_3d_tpu_torch.ops.sparse import SparseTensor


def _sample_offsets(num_bins: int, ratio: int, size):
    """(R, num_bins*ratio) local-axis sample coords for per-roi sizes."""
    bin_size = size / num_bins
    p = torch.arange(num_bins * ratio, device=size.device)
    bin_idx = torch.div(p, ratio, rounding_mode="floor")
    sub = torch.remainder(p, ratio).to(torch.float32)
    return (-size / 2)[:, None] + (
        bin_idx[None, :] * bin_size[:, None]
        + (sub[None, :] + 0.5) * bin_size[:, None] / ratio)


def roi_align_rotated_sparse(table: SparseTensor, rois, roi_valid,
                             out_size: Tuple[int, int, int],
                             sampling_ratio: int = 2, roi_batch=None):
    """Args:
      table: SparseTensor feature map (V, C);
      rois: (R, 7) standard-mode boxes in the table's voxel units
        [xc, yc, zc, xs, ys, zs, yaw];
      roi_valid: (R,) bool;
      out_size: (os0, os1, os2) bins along (x_size, y_size, z_size);
      roi_batch: optional (R,) batch coordinate per roi (the FPN level
        of the merged multi-level table, models/roi_head.pool_rois).

    Returns (R, os0, os1, os2, C) pooled features (invalid rois zero).
    """
    os0, os1, os2 = out_size
    sr = sampling_ratio
    r = rois.shape[0]
    c = table.num_channels
    dev = rois.device

    xc, yc, zc = rois[:, 0], rois[:, 1], rois[:, 2]
    xs = torch.clamp(rois[:, 3], min=1.0)
    ys = torch.clamp(rois[:, 4], min=1.0)
    zs = torch.clamp(rois[:, 5], min=1.0)
    yaw = rois[:, 6]
    lx = _sample_offsets(os0, sr, xs)     # (R, os0*sr)
    ly = _sample_offsets(os1, sr, ys)     # (R, os1*sr)
    lz = _sample_offsets(os2, sr, zs)     # (R, os2*sr)
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    gx = (lx[:, :, None] * cos[:, None, None]
          - ly[:, None, :] * sin[:, None, None] + xc[:, None, None])
    gy = (lx[:, :, None] * sin[:, None, None]
          + ly[:, None, :] * cos[:, None, None] + yc[:, None, None])
    gz = lz + zc[:, None]

    shape = (r, os0 * sr, os1 * sr, os2 * sr)
    px = gx[:, :, :, None].expand(shape)
    py = gy[:, :, :, None].expand(shape)
    pz = gz[:, None, None, :].expand(shape)
    if roi_batch is None:
        pb = torch.zeros(shape, dtype=torch.int32, device=dev)
    else:
        pb = roi_batch.to(torch.int32)[:, None, None, None].expand(shape)

    X, Y, Z = table.spatial_size
    inb = ((px > -1.0) & (px < X) & (py > -1.0) & (py < Y)
           & (pz > -1.0) & (pz < Z))
    px = torch.clamp(px, 0.0, X - 1)
    py = torch.clamp(py, 0.0, Y - 1)
    pz = torch.clamp(pz, 0.0, Z - 1)
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    z0 = torch.floor(pz).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=X - 1)
    y1 = torch.clamp(y0 + 1, max=Y - 1)
    z1 = torch.clamp(z0 + 1, max=Z - 1)
    fx, fy, fz = px - x0, py - y0, pz - z0
    inb_f = inb.to(fx.dtype)

    feats = table.feats
    acc = torch.zeros((r, os0, os1, os2, c), dtype=torch.float32, device=dev)
    # a missing corner reads a zero: it gathers some real row with weight
    # 0. The row is its sample's position modulo V, so the gradient's
    # scatter (index_select's backward adds with atomics) spreads the
    # zeros instead of piling every missing corner onto one row
    spread = torch.arange(px.numel(), device=dev).reshape(shape) % \
        table.capacity
    # one corner at a time: the sr^3 sub-samples are summed into the bin
    # grid inside the loop, so the full sample grid of features is never
    # held for all 8 corners at once
    for cx, wx in ((x0, 1 - fx), (x1, fx)):
        for cy, wy in ((y0, 1 - fy), (y1, fy)):
            for cz, wz in ((z0, 1 - fz), (z1, fz)):
                idx, found = table.lookup(torch.stack([cx, cy, cz, pb], -1))
                idx = torch.where(found, idx.to(torch.int64), spread)
                w = (wx * wy * wz * inb_f * found).to(feats.dtype)
                g = feats.index_select(0, idx.reshape(-1)).reshape(
                    shape + (c,)) * w[..., None]
                acc += g.reshape(r, os0, sr, os1, sr, os2, sr, c).sum(
                    dim=(2, 4, 6), dtype=torch.float32)
    pooled = (acc * (1.0 / (sr * sr * sr))).to(feats.dtype)
    return torch.where(roi_valid[:, None, None, None, None], pooled, 0.0)
