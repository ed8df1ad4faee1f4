"""Synthetic building-scene generator (test + smoke-run fixture).

A numpy-only copy of synthetic_building and synthetic_multiroom from the
JAX package's detection_3d_tpu/data/synthetic.py, so that the port and
chip_smoke.py need nothing from that package; the same seed gives the
same scene in both. Emulates what the SUNCG pipeline produces after
preprocessing (reference suncg_dataset.py:72-189): a point cloud with
xyz+color+normal features scaled by voxel_scale and shifted to the
positive octant, plus yx_zb ground-truth boxes with labels.
"""

from __future__ import annotations

import numpy as np


def standard_to_yx_zb_np(boxes):
    """numpy twin of ops.geometry.standard_to_yx_zb (bbox3d_ops.py:157-176);
    scene generation is host code."""
    xc, yc, zc, xs, ys, zs, yaw = np.split(np.asarray(boxes), 7, axis=-1)
    zb = zc - zs * 0.5
    yaw = yaw - np.pi * 0.5
    yaw = yaw - np.floor(yaw / np.pi + 0.5) * np.pi   # [-pi/2, pi/2]
    return np.concatenate([xc, yc, zb, ys, xs, zs, yaw], axis=-1)


def _box_surface_points(rng, center, size, yaw, n):
    """Sample n points on the two large faces of a thin box."""
    local = rng.uniform(-0.5, 0.5, (n, 3)) * size
    face = rng.randint(0, 2, n) * 2 - 1
    # thin axis = argmin(size): snap to the faces
    thin = int(np.argmin(size))
    local[:, thin] = face * size[thin] / 2
    c, s = np.cos(yaw), np.sin(yaw)
    world = np.empty_like(local)
    world[:, 0] = c * local[:, 0] + s * local[:, 1] + center[0]
    world[:, 1] = -s * local[:, 0] + c * local[:, 1] + center[1]
    world[:, 2] = local[:, 2] + center[2]
    return world


def synthetic_building(seed: int = 0, num_points: int = 60_000,
                       room: float = 8.0, wall_h: float = 2.7,
                       classes=("background", "wall", "door", "window",
                                "ceiling", "floor"),
                       voxel_scale: int = 50, yaw: float = 0.0):
    """Returns dict:
      points: (N, 3) float32 — xyz already x voxel_scale, min-shifted to >0;
      feats: (N, 9) float32 — xyz(m) + rgb + normal;
      gt_boxes: (M, 7) float32 yx_zb (meters);
      gt_labels: (M,) int32.
    """
    rng = np.random.RandomState(seed)
    t = 0.095  # 9.5 cm walls — the thin boxes the reference tunes for
    half = room / 2

    boxes_std = []  # standard: [xc,yc,zc,xs,ys,zs,yaw]
    labels = []
    from detection_3d_tpu_torch.data.dataset_metas import DatasetMetas
    name2lab = DatasetMetas(classes).class_2_label

    def rot_xy(x, y):
        c, s = np.cos(yaw), np.sin(yaw)
        return c * x + s * y, -s * x + c * y

    # 4 walls around the perimeter, split into <=2.5 m segments — the
    # reference's offline preprocessing crops walls at intersections
    # (wall_preprocessing.py), so real gt walls are short pieces
    max_seg = 2.5
    wall_specs = [
        (0.0, -half, room, 0.0), (0.0, half, room, 0.0),
        (-half, 0.0, room, np.pi / 2), (half, 0.0, room, np.pi / 2)]
    for wx, wy, length, wyaw in wall_specs:
        n_seg = max(1, int(np.ceil(length / max_seg)))
        seg_len = length / n_seg
        for si in range(n_seg):
            off = -length / 2 + (si + 0.5) * seg_len
            if wyaw == 0.0:
                sx_, sy_ = wx + off, wy
            else:
                sx_, sy_ = wx, wy + off
            cx, cy = rot_xy(sx_, sy_)
            boxes_std.append([cx, cy, wall_h / 2, seg_len, t, wall_h,
                              (wyaw + yaw) % np.pi])
            labels.append(name2lab["wall"])

    if "floor" in name2lab:
        boxes_std.append([0, 0, 0.06, room, room, 0.12, yaw % np.pi])
        labels.append(name2lab["floor"])
    if "ceiling" in name2lab:
        boxes_std.append([0, 0, wall_h - 0.06, room, room, 0.12,
                          yaw % np.pi])
        labels.append(name2lab["ceiling"])
    if "door" in name2lab:
        dx, dy = rot_xy(-half / 2, -half)
        boxes_std.append([dx, dy, 1.0, 0.9, t * 1.5, 2.0, yaw % np.pi])
        labels.append(name2lab["door"])
    if "window" in name2lab:
        wx_, wy_ = rot_xy(half / 2, -half)
        boxes_std.append([wx_, wy_, 1.5, 1.2, t * 1.5, 1.0, yaw % np.pi])
        labels.append(name2lab["window"])

    boxes_std = np.array(boxes_std, np.float32)
    labels = np.array(labels, np.int32)

    # points on surfaces, proportional to box area
    sizes = boxes_std[:, 3:6]
    areas = np.max(sizes, 1) * np.median(sizes, 1)
    weights = areas / areas.sum()
    counts = (weights * num_points).astype(int)
    opening_ids = [i for i, l in enumerate(labels)
                   if l in (name2lab.get("door", -1),
                            name2lab.get("window", -1))]
    pts = []
    for i, b in enumerate(boxes_std):
        p = _box_surface_points(rng, b[:3], b[3:6], b[6],
                                max(counts[i], 10))
        if labels[i] == name2lab["wall"] and opening_ids:
            # cut door/window openings out of the wall surfaces — real
            # scans have holes where the opening geometry replaces the
            # wall (suncg renders the actual meshes)
            keep = np.ones(p.shape[0], bool)
            for oi in opening_ids:
                ob = boxes_std[oi]
                c, s = np.cos(ob[6]), np.sin(ob[6])
                d = p[:, :2] - ob[:2]
                lx = c * d[:, 0] - s * d[:, 1]
                inside = (np.abs(lx) < ob[3] / 2) & \
                    (np.abs(p[:, 2] - ob[2]) < ob[5] / 2)
                keep &= ~inside
            p = p[keep]
        pts.append(p)
    pts = np.concatenate(pts, 0).astype(np.float32)
    pts += rng.normal(0, 0.004, pts.shape).astype(np.float32)  # sensor noise

    # features: xyz (meters) + color + normals (random unit)
    color = rng.uniform(0, 1, (pts.shape[0], 3)).astype(np.float32)
    nrm = rng.normal(size=(pts.shape[0], 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-9
    feats = np.concatenate([pts, color, nrm], axis=1)

    # scale + shift to positive octant (suncg_dataset.py:115-137)
    scaled = pts * voxel_scale
    shift = scaled.min(0)
    scaled = scaled - shift

    # gt to yx_zb with the same shift (boxes are in meters: shift/scale)
    boxes_shifted = boxes_std.copy()
    boxes_shifted[:, :3] -= shift / voxel_scale
    gt_yx_zb = standard_to_yx_zb_np(boxes_shifted)

    return {"points": scaled.astype(np.float32), "feats": feats,
            "gt_boxes": gt_yx_zb.astype(np.float32), "gt_labels": labels}


def synthetic_multiroom(seed: int = 0, num_points: int = 500_000,
                        rooms_xy=(4, 4), room: float = 8.0,
                        wall_h: float = 2.7,
                        classes=("background", "wall", "door", "window",
                                 "ceiling", "floor"),
                        voxel_scale: int = 50):
    """A full-scale building: a rooms_xy grid of rooms (default 4x4 x 8 m
    = ~32 m extent — the reference packs buildings to <= 40.9 m,
    indoor_data_util.py:22-25) with ~num_points points total. Matches the
    scale of one real SYNBIM building (500k points over a
    4096x4096x512 voxel grid at 2 cm)."""
    rng = np.random.RandomState(seed)
    nx, ny = rooms_xy
    n_rooms = nx * ny
    per_room = num_points // n_rooms

    merged = None
    for ry in range(ny):
        for rx in range(nx):
            s = seed * 1000 + ry * nx + rx
            sc = synthetic_building(
                seed=s, num_points=per_room, room=room, wall_h=wall_h,
                classes=classes, voxel_scale=1)  # unscaled meters
            off = np.array([(rx + 0.5) * room, (ry + 0.5) * room, 0.0],
                           np.float32)
            sc["points"] = sc["points"] + off
            sc["feats"][:, :3] += off
            sc["gt_boxes"][:, :3] += off  # yx_zb centers: xc, yc, z_bot
            if merged is None:
                merged = sc
            else:
                for k in ("points", "feats", "gt_boxes", "gt_labels"):
                    merged[k] = np.concatenate([merged[k], sc[k]], 0)

    # global scale + shift to the positive octant (suncg_dataset.py:115-137)
    scaled = merged["points"] * voxel_scale
    shift = scaled.min(0)
    merged["points"] = (scaled - shift).astype(np.float32)
    merged["gt_boxes"][:, :3] -= shift / voxel_scale
    return merged
