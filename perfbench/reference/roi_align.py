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

from perfbench.reference.sparse import SparseTensor


def _sample_offsets(num_bins: int, ratio: int, size):
    """(R, num_bins*ratio) local-axis sample coords for per-roi sizes."""
    bin_size = size / num_bins
    p = torch.arange(num_bins * ratio, device=size.device)
    bin_idx = torch.div(p, ratio, rounding_mode="floor")
    sub = torch.remainder(p, ratio).to(torch.float32)
    return (-size / 2)[:, None] + (
        bin_idx[None, :] * bin_size[:, None]
        + (sub[None, :] + 0.5) * bin_size[:, None] / ratio)


class _CornerGather(torch.autograd.Function):
    """``feats_pad[idx]``, ``feats_pad`` the features with one zero row
    appended (the missing corners' row, the last). Backward: the gradient
    of the found rows scattered onto their rows; a missing corner's, which
    is dropped, goes to its ``spread`` row with weight 0, so the
    scatter's atomics do not pile up on the zero row."""

    @staticmethod
    def forward(ctx, feats_pad, idx, spread):
        ctx.save_for_backward(idx, spread)
        ctx.rows = feats_pad.shape[0]
        return feats_pad.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, spread = ctx.saved_tensors
        found = idx < ctx.rows - 1
        d = g.new_zeros((ctx.rows, g.shape[1]))
        d.index_add_(0, torch.where(found, idx, spread),
                     g * found[:, None].to(g.dtype))
        return d, None, None


def roi_align_rotated_sparse(table: SparseTensor, rois, roi_valid,
                             out_size: Tuple[int, int, int],
                             sampling_ratio: int = 2, roi_batch=None):
    """Args:
      table: SparseTensor feature map (V, C), or a unit's stacked maps
        (B, V, C);
      rois: (R, 7) standard-mode boxes in the table's voxel units
        [xc, yc, zc, xs, ys, zs, yaw]; (B, R, 7) on a unit, building b's
        rois pooled from its own table;
      roi_valid: (R,) bool, or (B, R);
      out_size: (os0, os1, os2) bins along (x_size, y_size, z_size);
      roi_batch: optional (R,) (or (B, R)) batch coordinate per roi (the
        FPN level of the merged multi-level table,
        models/roi_head.pool_rois).

    Returns (R, os0, os1, os2, C) pooled features (invalid rois zero),
    with the leading B of a unit.
    """
    os0, os1, os2 = out_size
    sr = sampling_ratio
    t = table.stacked()
    nb, v = t.units, t.capacity
    lead = rois.shape[:-2]
    r = rois.shape[-2]
    rois = rois.reshape(nb * r, 7)
    c = t.num_channels
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

    shape = (nb * r, os0 * sr, os1 * sr, os2 * sr)
    px = gx[:, :, :, None].expand(shape)
    py = gy[:, :, :, None].expand(shape)
    pz = gz[:, None, None, :].expand(shape)
    if roi_batch is None:
        pb = torch.zeros(shape, dtype=torch.int32, device=dev)
    else:
        pb = roi_batch.reshape(-1).to(torch.int32)[:, None, None,
                                                   None].expand(shape)

    X, Y, Z = t.spatial_size
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

    feats = t.feats.reshape(nb * v, c)
    feats_pad = torch.cat([feats, feats.new_zeros((1, c))], 0)
    # each building's queries search its own table and read its own rows
    # (flat row b * V + idx); a missing corner reads the zero row nb * V
    base = (torch.arange(nb, device=dev) * v).reshape(
        (nb,) + (1,) * len(shape))
    unit_shape = (nb, r) + shape[1:]
    spread = (torch.arange(px.numel(), device=dev).reshape(unit_shape) % v
              + base).reshape(-1)
    acc = torch.zeros((nb * r, os0, os1, os2, c), dtype=torch.float32,
                      device=dev)
    # one corner at a time: the sr^3 sub-samples are summed into the bin
    # grid inside the loop, so the full sample grid of features is never
    # held for all 8 corners at once
    for cx, wx in ((x0, 1 - fx), (x1, fx)):
        for cy, wy in ((y0, 1 - fy), (y1, fy)):
            for cz, wz in ((z0, 1 - fz), (z1, fz)):
                q = torch.stack([cx, cy, cz, pb], -1).reshape(
                    unit_shape + (4,))
                idx, found = t.lookup(q)
                idx = torch.where(found, idx.to(torch.int64) + base, nb * v)
                w = (wx * wy * wz * inb_f).to(feats.dtype)
                g = _CornerGather.apply(feats_pad, idx.reshape(-1), spread)
                g = g.reshape(shape + (c,)) * w[..., None]
                acc += g.reshape(nb * r, os0, sr, os1, sr, os2, sr, c).sum(
                    dim=(2, 4, 6), dtype=torch.float32)
    pooled = (acc * (1.0 / (sr * sr * sr))).to(feats.dtype)
    pooled = torch.where(roi_valid.reshape(-1)[:, None, None, None, None],
                         pooled, 0.0)
    return pooled.reshape(lead + (r, os0, os1, os2, c))
