"""A building's input on its way to the device: padding and quantized
packing.

:func:`pad_scene` pads a scene dict to the static capacities (numpy,
on the host) and :func:`batch_to_device` moves such a padded batch to
the device (the JAX package keeps both in its engine/trainer.py).

The rest is the counterpart of detection_3d_tpu/data/packing.py. A
building's padded f32
input is 24.5 MB (points 6 MB, 9-channel features 18 MB, the valid
mask); the packers ship compact fixed-point arrays instead and the
device rebuilds floats by elementwise work only:

- :func:`pack_scene` -> :func:`unpack_batch`: the padded points,
  quantized (6.5 MB a 500k-point building). Scaled voxel coords go as
  u16 at 1/8 voxel; ``floor(floor(8p)/8) == floor(p)`` for p >= 0, so
  the device's voxelization is bit exact against the f32 path. xyz in
  metres comes back from the same coords plus a per-scene f32 origin
  (the median of the residuals), rgb in [0, 1] goes as u8, normals in
  [-1, 1] as i8; the valid mask becomes one count.
- :func:`pack_table` -> :func:`unpack_table`: the whole input layer on
  the host (sort, dedup-average with the strided capacity-overflow
  keep, quantize), so the device skips the voxelize stage. Coords, keys,
  ``num`` and ``true_num`` are bit exact against
  models/detector.voxelize_points; features carry at most 1/512 voxel
  (xyz), 1/510 (rgb) and 1/254 (normals) of quantization error.

The pack functions are numpy on the host; the unpack functions are
plain torch on the device the packed tensors lie on.
:func:`to_device` moves a packed dict there.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.ops.coords import INVALID, pack_key
from detection_3d_tpu_torch.ops.sparse import SparseTensor
from detection_3d_tpu_torch.utils.profiling import span

_LOG = logging.getLogger(__name__)

XYZ_FP = 8  # fixed-point denominator for scaled voxel coords


def pad_scene(cfg, scene: Dict) -> Dict[str, np.ndarray]:
    """Host-side: pad a scene dict to the static capacities, warning when
    points or gt boxes exceed them (silent loss of input is never
    acceptable). A scene with per-point ``point_labels`` (a segmentation
    model's) gives them padded with -1. Runs in the span
    ``data.pad_scene``."""
    with span("data.pad_scene"):
        n = cfg.caps.max_points
        pts = np.zeros((n, 3), np.float32)
        fts = np.zeros((n, cfg.in_channels), np.float32)
        m = min(scene["points"].shape[0], n)
        if scene["points"].shape[0] > n:
            _LOG.warning(
                "pad_scene: %d points exceed caps.max_points=%d — dropping "
                "%.1f%% of the input (raise caps.max_points)",
                scene["points"].shape[0], n,
                100.0 * (1 - n / scene["points"].shape[0]))
        pts[:m] = scene["points"][:m]
        fts[:m] = scene["feats"][:m, :cfg.in_channels]
        pvalid = np.arange(n) < m

        g = cfg.caps.max_gt
        gtb = np.zeros((g, 7), np.float32)
        gtb[:, 3:6] = 0.1  # harmless nonzero sizes on padding rows
        gtl = np.zeros((g,), np.int32)
        mg = min(scene["gt_boxes"].shape[0], g)
        gtb[:mg] = scene["gt_boxes"][:mg]
        gtl[:mg] = scene["gt_labels"][:mg]
        gvalid = np.arange(g) < mg
        if scene["gt_boxes"].shape[0] > g:
            _LOG.warning(
                "pad_scene: %d gt boxes exceed caps.max_gt=%d — dropping %d "
                "targets (raise caps.max_gt)",
                scene["gt_boxes"].shape[0], g, scene["gt_boxes"].shape[0] - g)
        out = {"points": pts, "feats": fts, "points_valid": pvalid,
               "gt_boxes": gtb, "gt_labels": gtl, "gt_valid": gvalid}
        if "point_labels" in scene:
            out["point_labels"] = np.full((n,), -1, np.int32)
            out["point_labels"][:m] = scene["point_labels"][:m]
        return out


def batch_to_device(batch: Dict[str, np.ndarray], dev):
    """((points, feats, points_valid), gt Boxes3D, gt labels) of a padded
    batch, on ``dev``."""
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    return (b["points"], b["feats"], b["points_valid"]), \
        Boxes3D(b["gt_boxes"], b["gt_valid"]), b["gt_labels"]


def pack_scene(cfg, scene: Dict) -> Dict[str, np.ndarray]:
    """Host side: pad to static capacities and quantize.

    Requires the canonical 9-channel feature layout xyz(m)+rgb+normal.
    """
    if cfg.in_channels != 9:
        raise ValueError(
            f"pack_scene supports the 9-channel xyz+rgb+normal layout, "
            f"got in_channels={cfg.in_channels}")
    if max(cfg.sparse3d.voxel_full_scale) * XYZ_FP >= 1 << 16:
        raise ValueError("voxel_full_scale too large for u16 fixed point")

    batch = pad_scene(cfg, scene)
    pts = batch["points"]                   # scaled voxel coords, >= 0
    m = int(batch["points_valid"].sum())
    xyz_q = np.floor(np.clip(pts, 0, None) * XYZ_FP).astype(np.uint16)

    feats = batch["feats"]
    # per-scene affine origin: xyz_m = pts / voxel_scale + origin
    scale = float(cfg.sparse3d.voxel_scale)
    res = feats[:m, :3] - pts[:m] / scale
    origin = (np.median(res, axis=0).astype(np.float32)
              if m else np.zeros(3, np.float32))
    rgb_q = np.round(np.clip(feats[:, 3:6], 0.0, 1.0) * 255.0).astype(
        np.uint8)
    nrm_q = np.round(np.clip(feats[:, 6:9], -1.0, 1.0) * 127.0).astype(
        np.int8)
    return {
        "xyz_q": xyz_q, "rgb_q": rgb_q, "nrm_q": nrm_q,
        "n_valid": np.int32(m), "origin": origin,
        "gt_boxes": batch["gt_boxes"], "gt_labels": batch["gt_labels"],
        "gt_valid": batch["gt_valid"],
    }


def pack_table(cfg, scene: Dict) -> Dict[str, np.ndarray]:
    """Host side: the full input layer — sort, dedup-average, quantize.

    Bit exact against ops/sparse.build_sparse_tensor on coords, keys,
    ``num`` and ``true_num``, the unbiased strided capacity-overflow keep
    included; features within the quantization steps above.
    """
    if cfg.in_channels != 9:
        raise ValueError("pack_table supports the 9-channel layout only")
    X, Y, Z = cfg.sparse3d.voxel_full_scale
    cap = cfg.caps.scale_caps(cfg.sparse3d.num_scales)[0]
    if max(X, Y, Z) >= 1 << 16 or cap >= 1 << 16 * 2:
        raise ValueError("grid too large for u16 table packing")

    batch = pad_scene(cfg, scene)
    m = int(batch["points_valid"].sum())
    pts = batch["points"][:m]
    feats = batch["feats"][:m]
    scale = float(cfg.sparse3d.voxel_scale)
    res0 = feats[:, :3] - pts / scale
    origin = (np.median(res0, axis=0).astype(np.float32)
              if m else np.zeros(3, np.float32))

    vox = np.floor(pts).astype(np.int64)
    inb = ((vox[:, 0] >= 0) & (vox[:, 0] < X) & (vox[:, 1] >= 0)
           & (vox[:, 1] < Y) & (vox[:, 2] >= 0) & (vox[:, 2] < Z))
    vox, pts, feats = vox[inb], pts[inb], feats[inb]
    # device sort key: hi = b*X + x, lo = y*Z + z (ops/coords.pack_key)
    hi = vox[:, 0]
    lo = vox[:, 1] * Z + vox[:, 2]
    order = np.lexsort((lo, hi))
    vox, pts, feats = vox[order], pts[order], feats[order]
    key = hi[order] * (Y * Z) + lo[order]

    is_first = np.ones(key.shape[0], bool)
    is_first[1:] = key[1:] != key[:-1]
    seg_id = np.cumsum(is_first) - 1
    num_vox = int(seg_id[-1]) + 1 if key.shape[0] else 0
    stride = max(-(-num_vox // cap), 1)
    keep = (seg_id % stride) == 0
    slot = seg_id // stride
    num = min(-(-num_vox // stride), cap)

    vox_out = np.zeros((cap, 3), np.uint16)
    res_q = np.zeros((cap, 3), np.uint8)
    rgb_q = np.zeros((cap, 3), np.uint8)
    nrm_q = np.zeros((cap, 3), np.int8)
    if num:
        sl = slot[keep]
        cnt = np.bincount(sl, minlength=num).astype(np.float64)[:, None]

        def seg_mean(a):
            out = np.zeros((num, a.shape[1]), np.float64)
            np.add.at(out, sl, a[keep].astype(np.float64))
            return out / np.maximum(cnt, 1.0)

        first = np.full(num, vox.shape[0], np.int64)
        np.minimum.at(first, sl, np.flatnonzero(keep))
        vox_out[:num] = vox[first].astype(np.uint16)
        res = seg_mean(pts) - vox[first]
        res_q[:num] = np.clip(np.floor(res * 256.0), 0, 255).astype(
            np.uint8)
        rgb_q[:num] = np.round(
            np.clip(seg_mean(feats[:, 3:6]), 0.0, 1.0) * 255.0).astype(
            np.uint8)
        nrm_q[:num] = np.round(
            np.clip(seg_mean(feats[:, 6:9]), -1.0, 1.0) * 127.0).astype(
            np.int8)
    return {
        "vox": vox_out, "res_q": res_q, "rgb_q": rgb_q, "nrm_q": nrm_q,
        "num": np.int32(num), "true_num": np.int32(num_vox),
        "origin": origin,
        "gt_boxes": batch["gt_boxes"], "gt_labels": batch["gt_labels"],
        "gt_valid": batch["gt_valid"],
    }


def to_device(packed: Dict, device, non_blocking: bool = False
              ) -> Dict[str, torch.Tensor]:
    """A packed dict (numpy arrays or tensors) as tensors on ``device``,
    dtypes unchanged; tensors already there are passed through."""
    return {k: torch.as_tensor(v).to(device, non_blocking=non_blocking)
            for k, v in packed.items()}


def device_table(vox, num, spatial, feats=None, true_num=None
                 ) -> SparseTensor:
    """A SparseTensor from (V, 3) unsigned coords whose first ``num`` rows
    are the sorted active voxels of batch 0: the pad rows are re-marked
    INVALID and the keys rebuilt, elementwise. Stacked (B, V, 3) coords
    and (B,) counts give a unit's stacked tables."""
    vox = vox.to(torch.int32)
    v = vox.shape[-2]
    rowv = torch.arange(v, device=vox.device) < num[..., None]
    coords4 = torch.cat([vox, torch.zeros_like(vox[..., :1])], -1)
    coords4 = torch.where(rowv[..., None], coords4, INVALID)
    hi, lo = pack_key(coords4, spatial, rowv)
    if feats is None:
        feats = torch.zeros(vox.shape[:-1] + (0,), dtype=torch.float32,
                            device=vox.device)
    return SparseTensor(coords4, feats, hi, lo, num, spatial, 1,
                        true_num=true_num)


def _feats(cfg, xyz, rgb_q, nrm_q, origin):
    """(..., n, 9) f32 features from scaled xyz and the quantized
    channels."""
    xyz_m = xyz * (1.0 / float(cfg.sparse3d.voxel_scale)) \
        + origin[..., None, :]
    return torch.cat([xyz_m, rgb_q.to(torch.float32) * (1.0 / 255.0),
                      nrm_q.to(torch.float32) * (1.0 / 127.0)], -1)


def unpack_table(cfg, packed) -> SparseTensor:
    """Device side: a :func:`pack_table` dict (tensors) -> the scale-0
    SparseTensor, with ``true_num``. Elementwise work only: the host
    already ordered and deduplicated the rows. A dict stacked over B
    buildings gives the unit's stacked tables."""
    num = packed["num"]
    xyz = (packed["vox"].to(torch.float32)
           + packed["res_q"].to(torch.float32) * (1.0 / 256.0))
    feats = _feats(cfg, xyz, packed["rgb_q"], packed["nrm_q"],
                   packed["origin"])
    rowv = torch.arange(feats.shape[-2], device=feats.device) \
        < num[..., None]
    feats = torch.where(rowv[..., None], feats, 0.0)
    return device_table(packed["vox"], num, cfg.sparse3d.voxel_full_scale,
                        feats, true_num=packed["true_num"])


def unpack_batch(cfg, packed) -> Dict[str, torch.Tensor]:
    """Device side: a :func:`pack_scene` dict (tensors) -> the f32 batch
    dict of :func:`pad_scene` (each array with the leading B of a
    stacked dict)."""
    pts = packed["xyz_q"].to(torch.float32) * (1.0 / XYZ_FP)
    feats = _feats(cfg, pts, packed["rgb_q"], packed["nrm_q"],
                   packed["origin"])
    valid = torch.arange(pts.shape[-2], device=pts.device) \
        < packed["n_valid"][..., None]
    return {"points": pts, "feats": feats, "points_valid": valid,
            "gt_boxes": packed["gt_boxes"],
            "gt_labels": packed["gt_labels"],
            "gt_valid": packed["gt_valid"]}
