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

On the card :func:`roi_align_rotated_sparse` runs csrc/roi_align.cu
through :class:`RotatedROIAlign`: one forward launch a call (every bin's
corners looked up, weighted and summed in f32 registers) and, when a
gradient is wanted, one backward call (a kernel writes the same lookups
as (row, weight) pairs, plain torch sorts them by row and finds each
row's first pair, and a kernel sums each row's weighted bin gradients in
f32 in that order: no atomics). CPU tensors run the plain version,
:func:`roi_align_plain`, which takes the corners one at a time under
autograd; the card's tests hold the kernels against it. The rois are
constants (proposals carry no gradient): the Function gives them none.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.sparse import SparseTensor

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_VEC = 4    # channels a lane of the kernels' vector form


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


def roi_align_plain(table: SparseTensor, rois, roi_valid,
                    out_size: Tuple[int, int, int], sampling_ratio: int = 2,
                    roi_batch=None):
    """The plain version (the CPU path; autograd gives its gradient).
    Arguments and result as :func:`roi_align_rotated_sparse`."""
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


# ---- the card's kernels (csrc/roi_align.cu) --------------------------------

def _check(name, x, keys, rois, roi_valid, roi_batch):
    """Raises unless the kernels can take these: ``x`` the features or
    their gradient (None where a kernel reads neither)."""
    if x is None:
        x = keys
    elif x.dtype not in _DTYPE_TAG:
        raise ValueError(f"{name}: features {x.dtype}: expected float32 or "
                         "bfloat16")
    if not x.is_cuda:
        raise ValueError(f"{name}: inputs on {x.device}: the kernels take "
                         "CUDA tensors")
    if rois.dtype != torch.float32:
        raise ValueError(f"{name}: rois {rois.dtype}: expected float32")
    if keys.dtype != torch.int64 or keys.dim() != 2 or \
            keys.numel() >= 2 ** 31:
        raise ValueError(f"{name}: expected int64 keys (nb, V) of under "
                         f"2^31 rows, got {keys.dtype} {tuple(keys.shape)}")
    n = rois.shape[0]
    if rois.shape != (n, 7) or roi_valid.shape != (n,) or \
            roi_valid.dtype != torch.bool or n % keys.shape[0]:
        raise ValueError(f"{name}: expected rois (nb R, 7) and a bool mask "
                         f"(nb R,) over {keys.shape[0]} buildings; got "
                         f"{tuple(rois.shape)} and {tuple(roi_valid.shape)} "
                         f"{roi_valid.dtype}")
    if roi_batch is not None and (roi_batch.shape != (n,)
                                  or roi_batch.dtype != torch.int32):
        raise ValueError(f"{name}: expected int32 levels (nb R,)")
    for t in (x, keys, rois, roi_valid) + (() if roi_batch is None
                                           else (roi_batch,)):
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous inputs")


def _vec(c, *rows) -> int:
    """1 when a lane may take 4 channels at once: C a multiple of 4 and
    every row tensor aligned to 4 elements."""
    return int(c % _VEC == 0 and all(
        t.data_ptr() % (_VEC * t.element_size()) == 0 for t in rows))


def _geometry(keys, rois, c, spatial, out_size, sr):
    nb, v = keys.shape
    return (nb, rois.shape[0] // nb, v, c, *out_size, sr, *spatial,
            1.0 / (sr * sr * sr))


def roi_align_cuda(feats, keys, rois, roi_valid, roi_batch, spatial,
                   out_size, sr):
    """The forward kernel: feats (nb * V, C) float32 or bfloat16, keys
    (nb, V) int64, rois (nb * R, 7) float32, roi_valid (nb * R,) bool,
    roi_batch (nb * R,) int32 or None, all contiguous on the card ->
    (nb * R, os0, os1, os2, C) in the features' type, as
    :func:`roi_align_plain` gives it (the weights and products kept in
    f32, the sum rounded once)."""
    _check("roi_align_cuda", feats, keys, rois, roi_valid, roi_batch)
    c = feats.shape[-1]
    out = torch.empty((rois.shape[0], *out_size, c), dtype=feats.dtype,
                      device=feats.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.library("roi_align")
    status = getattr(lib, f"roi_align_fwd_{_DTYPE_TAG[feats.dtype]}")(
        feats.data_ptr(), keys.data_ptr(), rois.data_ptr(),
        roi_valid.data_ptr(), 0 if roi_batch is None else roi_batch.data_ptr(),
        out.data_ptr(), *_geometry(keys, rois, c, spatial, out_size, sr),
        _vec(c, feats, out), cuda_lib.stream_ptr(feats.device))
    cuda_lib.check("roi_align", status)
    cuda_lib.launches["roi_align"] += 1
    return out


def roi_align_pairs_cuda(keys, rois, roi_valid, roi_batch, spatial,
                         out_size, sr):
    """The backward's first kernel: every corner of every bin as a (row,
    w / sr^3) pair, 2 * 4 * sr^3 slots a bin, in the bins' order: (rows
    int32, w float32). A missing corner, and every slot of an invalid
    roi, takes the row nb * V (after every real row). Arguments as
    :func:`roi_align_cuda`'s; the keys' device is the kernel's."""
    _check("roi_align_pairs_cuda", None, keys, rois, roi_valid, roi_batch)
    n = rois.shape[0] * math.prod(out_size) * 2 * 4 * sr ** 3
    if n >= 2 ** 31:
        raise ValueError(f"roi_align_pairs_cuda: {n} corner pairs; under "
                         "2^31")
    rows = torch.empty((n,), dtype=torch.int32, device=keys.device)
    w = torch.empty((n,), dtype=torch.float32, device=keys.device)
    geometry = _geometry(keys, rois, 1, spatial, out_size, sr)
    cuda_lib.check("roi_align", cuda_lib.library("roi_align")
                   .roi_align_bwd_pairs(
                       keys.data_ptr(), rois.data_ptr(), roi_valid.data_ptr(),
                       0 if roi_batch is None else roi_batch.data_ptr(),
                       rows.data_ptr(), w.data_ptr(), *geometry[:3],
                       *geometry[4:], cuda_lib.stream_ptr(keys.device)))
    return rows, w


def roi_align_bwd_cuda(grad, keys, rois, roi_valid, roi_batch, spatial,
                       out_size, sr):
    """The backward: ``grad`` (nb * R, os0, os1, os2, C) contiguous in the
    features' type -> the features' gradient (nb * V, C) in that type.
    :func:`roi_align_pairs_cuda` writes every corner as a (row, weight)
    pair, torch's stable sort orders them by row and ``searchsorted``
    finds each row's first pair (both plain torch), and a kernel sums
    each row's pairs in that order in f32: no atomics, the same bits on
    every call. Counted once, as one ``roi_align_bwd``."""
    _check("roi_align_bwd_cuda", grad, keys, rois, roi_valid, roi_batch)
    c = grad.shape[-1]
    nrows = keys.numel()
    dev = grad.device
    d = torch.empty((nrows, c), dtype=grad.dtype, device=dev)
    if d.numel() == 0:
        return d
    rows, w = roi_align_pairs_cuda(keys, rois, roi_valid, roi_batch, spatial,
                                   out_size, sr)
    sorted_rows, order = torch.sort(rows, stable=True)
    starts = torch.searchsorted(
        sorted_rows, torch.arange(nrows + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    cuda_lib.check("roi_align", getattr(
        cuda_lib.library("roi_align"),
        f"roi_align_bwd_sum_{_DTYPE_TAG[grad.dtype]}")(
            grad.data_ptr(), order.data_ptr(), w.data_ptr(),
            starts.data_ptr(), d.data_ptr(), nrows, c, 2 * 4 * sr ** 3,
            _vec(c, grad, d), cuda_lib.stream_ptr(dev)))
    cuda_lib.launches["roi_align_bwd"] += 1
    return d


class RotatedROIAlign(torch.autograd.Function):
    """The pooler on the card with its closed-form backward, the kernels
    of csrc/roi_align.cu (CUDA tensors only: the wrappers refuse others).
    ``feats`` (nb, V, C) is the only input with a gradient; the table
    gives the keys and the grid. Saves the keys and the rois, nothing of
    the features: the backward looks the corners up again."""

    @staticmethod
    def forward(ctx, feats, table, rois, roi_valid, roi_batch, out_size, sr):
        nb, v, c = feats.shape
        keys = table.keys.reshape(nb, v).contiguous()
        ctx.meta = (table.spatial_size, tuple(out_size), sr, feats.shape)
        ctx.save_for_backward(keys, rois, roi_valid, roi_batch)
        return roi_align_cuda(feats.reshape(nb * v, c).contiguous(), keys,
                              rois, roi_valid, roi_batch, table.spatial_size,
                              out_size, sr)

    @staticmethod
    def backward(ctx, grad):
        keys, rois, roi_valid, roi_batch = ctx.saved_tensors
        spatial, out_size, sr, fshape = ctx.meta
        d = roi_align_bwd_cuda(grad.contiguous(), keys, rois, roi_valid,
                               roi_batch, spatial, out_size, sr)
        return d.reshape(fshape), None, None, None, None, None, None


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
    with the leading B of a unit. CPU tensors run the plain version;
    CUDA tensors :class:`RotatedROIAlign` (float32 or bfloat16 features
    and float32 rois that take no gradient, else it raises).
    """
    if not table.feats.is_cuda:
        return roi_align_plain(table, rois, roi_valid, out_size,
                               sampling_ratio, roi_batch)
    if rois.requires_grad:
        raise ValueError("roi_align_rotated_sparse: the rois take no "
                         "gradient (proposals are constants)")
    t = table.stacked()
    nb = t.units
    lead = rois.shape[:-2]
    r = rois.shape[-2]
    level = None if roi_batch is None else \
        roi_batch.reshape(-1).to(torch.int32).contiguous()
    out = RotatedROIAlign.apply(
        t.feats, t, rois.reshape(nb * r, 7).contiguous(),
        roi_valid.reshape(-1).contiguous(), level, tuple(out_size),
        sampling_ratio)
    return out.reshape(lead + (r,) + tuple(out_size) + (out.shape[-1],))
