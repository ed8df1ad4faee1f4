"""Point-cloud augmentation hooks.

A numpy copy of the JAX package's detection_3d_tpu/data/augment.py (the
same seed and flags give the same bytes). The reference defines zoom /
x-flip / rotation / elastic-distortion / origin-offset augmentations in
the dataset but ships with ALL of them disabled (suncg_dataset.py:78-83:
``flip_x = False and is_train`` etc.). They are provided here for
completeness, host-side numpy (augmentation happens in the data loader,
off the card), default-off to match the reference configuration.
"""

from __future__ import annotations

import numpy as np


def elastic_distortion(points, granularity, magnitude, rng):
    """SCN-style elastic distortion (suncg_dataset.py elastic()): smooth
    random displacement field sampled at ``granularity`` spacing."""
    blur = np.ones((3, 1, 1), np.float32) / 3
    bb = (np.abs(points).max(0) // granularity).astype(np.int32) + 3
    noise = [rng.randn(*bb).astype(np.float32) for _ in range(3)]

    def smooth(a):
        for axis in range(3):
            a = np.apply_along_axis(
                lambda m: np.convolve(m, np.ones(3) / 3, mode="same"),
                axis, a)
        return a

    noise = [smooth(smooth(n)) for n in noise]
    ax = [np.linspace(-(b - 1) * granularity, (b - 1) * granularity, b)
          for b in bb]

    def interp(p):
        idx = [np.clip(np.searchsorted(ax[i], p[:, i]), 0, bb[i] - 1)
               for i in range(3)]
        return np.stack([noise[i][idx[0], idx[1], idx[2]]
                         for i in range(3)], 1)

    return points + interp(points) * magnitude


def augment_scene(scene, rng, zoom_rate: float = 0.0, flip_x: bool = False,
                  rotate: bool = False, elastic: bool = False,
                  norm_noise: float = 0.0, voxel_scale: int = 50):
    """Apply the reference's augmentation set to a scene dict.

    All flags default OFF (reference ships them disabled). Points are in
    scaled voxel units; gt boxes yx_zb meters.
    """
    pts = scene["points"].copy()
    feats = scene["feats"].copy()
    gt = scene["gt_boxes"].copy()

    m = np.eye(3) + rng.randn(3, 3) * zoom_rate
    if flip_x:
        m[0, 0] *= rng.randint(0, 2) * 2 - 1
    if rotate:
        th = rng.rand() * 2 * np.pi
        rot = np.array([[np.cos(th), np.sin(th), 0],
                        [-np.sin(th), np.cos(th), 0], [0, 0, 1]])
        m = m @ rot
    pts = pts @ m.astype(np.float32)
    if elastic:
        pts = elastic_distortion(pts, 6 * voxel_scale // 50,
                                 40 * voxel_scale / 50, rng)
    pts -= pts.min(0)
    if norm_noise > 0 and feats.shape[1] >= 9:
        feats[:, 6:9] += rng.randn(3).astype(np.float32) * norm_noise
    # NOTE: gt transform only valid for rigid subsets (flip/rotate); the
    # reference applies only the shift since all aug is disabled
    out = dict(scene)
    out["points"] = pts.astype(np.float32)
    out["feats"] = feats
    out["gt_boxes"] = gt
    return out
