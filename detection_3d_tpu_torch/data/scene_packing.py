"""Scene splitting / packing for oversized buildings.

A numpy copy of split_scene from the JAX package's
detection_3d_tpu/data/scene_packing.py (the same scene and rng give the
same blocks). Parity with the reference's offline packing
(reference data3d/suncg_utils/indoor_data_util.py:21-36 and the
MAX_SIZE_FOR_VOXEL_FULL_SCALE logic): buildings larger than the voxel
grid's metric extent are split into xy blocks of at most ``max_size_m``
(reference: 40.96 m at VOXEL_FULL_SCALE 2048 and scale 50; z never
split, BLOCK_SIZE0=[50, 50, -1]); each block's point count is sampled
down to ``max_points`` (reference: 500k).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def split_scene(scene: Dict[str, np.ndarray], max_size_m: float = 40.96,
                max_points: int = 500_000, min_points: int = 1024,
                overlap_m: float = 0.5, rng=None) -> List[Dict]:
    """Split one scene dict into xy blocks.

    GT boxes are assigned to a block when their centroid falls inside it;
    points within ``overlap_m`` of the block keep conv context at the
    seams. Blocks re-shift to the positive octant (the dataset transform
    expects min 0).
    """
    rng = rng or np.random.RandomState(0)
    pts = scene["points"]
    feats = scene["feats"]
    gt = scene["gt_boxes"]
    labels = scene["gt_labels"]
    scale = scene.get("voxel_scale", 1.0)

    # points are in scaled voxel units; work in meters
    pm = pts / scale if scale != 1.0 else pts
    mn, mx = pm.min(0), pm.max(0)
    extent = mx - mn
    nx = max(1, int(np.ceil(extent[0] / max_size_m)))
    ny = max(1, int(np.ceil(extent[1] / max_size_m)))
    if nx == 1 and ny == 1 and pts.shape[0] <= max_points:
        return [scene]

    bx = extent[0] / nx
    by = extent[1] / ny
    out = []
    for ix in range(nx):
        for iy in range(ny):
            x0 = mn[0] + ix * bx
            y0 = mn[1] + iy * by
            pmask = ((pm[:, 0] >= x0 - overlap_m)
                     & (pm[:, 0] < x0 + bx + overlap_m)
                     & (pm[:, 1] >= y0 - overlap_m)
                     & (pm[:, 1] < y0 + by + overlap_m))
            if pmask.sum() < min_points:
                continue
            gmask = ((gt[:, 0] >= x0) & (gt[:, 0] < x0 + bx)
                     & (gt[:, 1] >= y0) & (gt[:, 1] < y0 + by))
            p = pts[pmask]
            f = feats[pmask]
            if p.shape[0] > max_points:
                sel = rng.choice(p.shape[0], max_points, replace=False)
                p, f = p[sel], f[sel]
            shift = p.min(0)
            p = p - shift
            g = gt[gmask].copy()
            g[:, :3] -= shift / scale if scale != 1.0 else shift
            out.append({"points": p.astype(np.float32), "feats": f,
                        "gt_boxes": g.astype(np.float32),
                        "gt_labels": labels[gmask]})
    return out
