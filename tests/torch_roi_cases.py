"""Tables and rois for the ROI pooler's tests, torch and numpy only (no
JAX): tests/test_torch_roi_align.py (CPU) and
tests/test_torch_roi_align_cuda.py (the card) share them."""

import numpy as np
import torch

from detection_3d_tpu_torch.ops.sparse import build_sparse_tensor


def roi_table(nb=1, caps=(200, 100), c=3, spatial=(12, 10, 8), seed=0,
              dtype=torch.float64, device="cpu"):
    """A merged multi-level table (models/roi_head.merge_roi_levels' form:
    the batch coordinate is the level): level l holds caps[l] distinct
    random voxels of the grid, features N(0, 1). A unit of ``nb``
    buildings (stacked) when nb > 1, else one building's table."""
    rng = np.random.RandomState(seed)
    X, Y, Z = spatial
    n = sum(caps)
    coords, feats = [], []
    for _ in range(nb):
        rows = []
        for lv, cap in enumerate(caps):
            cells = rng.choice(X * Y * Z, size=cap, replace=False)
            x, y, z = np.unravel_index(cells, (X, Y, Z))
            rows.append(np.c_[x, y, z, np.full(cap, lv)])
        coords.append(np.concatenate(rows).astype(np.int32))
        feats.append(rng.randn(n, c))
    table = build_sparse_tensor(
        torch.from_numpy(np.stack(coords)).to(device),
        torch.from_numpy(np.stack(feats)).to(device=device, dtype=dtype),
        None, spatial, len(caps), n, reduce="sum")
    return table if nb > 1 else table.building(0)


def roi_boxes(nb=1, r=6, levels=2, spatial=(12, 10, 8), size=(0.3, 6.0),
              seed=0, device="cpu"):
    """(rois, roi_valid, roi_batch) of ``r`` rois a building ((nb, r, ...)
    for nb > 1): float32 standard boxes in voxel units, centres over the
    grid and a voxel beyond it, sizes in ``size`` (some under the 1-voxel
    floor), any yaw. Roi 0 lies wholly outside the grid (every sample out
    of bounds), roi 1 is invalid; levels uniform (None for one level)."""
    rng = np.random.RandomState(seed + 1000)
    lo, hi = size
    lead = (nb,) if nb > 1 else ()
    ctr = np.stack([rng.uniform(-1.0, s + 1.0, lead + (r,))
                    for s in spatial], -1)
    ext = rng.uniform(lo, hi, lead + (r, 3))
    yaw = rng.uniform(-np.pi, np.pi, lead + (r, 1))
    rois = np.concatenate([ctr, ext, yaw], -1).astype(np.float32)
    rois[..., 0, :3] = (-9.0, -9.0, -9.0)
    valid = np.ones(lead + (r,), bool)
    valid[..., 1] = False
    batch = None if levels == 1 else torch.from_numpy(
        rng.randint(0, levels, lead + (r,))).to(device)
    return (torch.from_numpy(rois).to(device), torch.from_numpy(valid).to(
        device), batch)
