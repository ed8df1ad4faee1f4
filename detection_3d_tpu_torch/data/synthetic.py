"""Synthetic building-scene generator (test + smoke-run fixture).

A numpy-only copy of synthetic_building, synthetic_varied_building and
synthetic_multiroom from the JAX package's
detection_3d_tpu/data/synthetic.py, so that the port and chip_smoke.py
need nothing from that package; the same seed gives the
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


def _face_points(rng, center, size, yaw, n, side):
    """Sample n points on ONE large face of a thin box (side = -1/+1 along
    the thin local axis). The visibility-culled replacement for
    _box_surface_points: a scanner inside a room only ever sees the face
    of a wall/slab that borders that room — the stand-in for the
    reference's depth-render pcl generation (gen_pcl/depth_2_pcl,
    reference data3d/suncg_utils/suncg_preprocess.py:673-834),
    which produces exactly this one-sided, interior-visible density."""
    local = rng.uniform(-0.5, 0.5, (n, 3)) * size
    thin = int(np.argmin(size))
    local[:, thin] = side * size[thin] / 2
    c, s = np.cos(yaw), np.sin(yaw)
    world = np.empty_like(local)
    world[:, 0] = c * local[:, 0] + s * local[:, 1] + center[0]
    world[:, 1] = -s * local[:, 0] + c * local[:, 1] + center[1]
    world[:, 2] = local[:, 2] + center[2]
    return world


def _cut_openings(p, openings):
    """Drop points falling inside opening (door/window) volumes."""
    if not openings:
        return p
    keep = np.ones(p.shape[0], bool)
    for ob in openings:
        c, s = np.cos(ob[6]), np.sin(ob[6])
        d = p[:, :2] - ob[:2]
        lx = c * d[:, 0] - s * d[:, 1]
        ly = s * d[:, 0] + c * d[:, 1]
        inside = (np.abs(lx) < ob[3] / 2) & (np.abs(ly) < ob[4] / 2 + 0.05) \
            & (np.abs(p[:, 2] - ob[2]) < ob[5] / 2)
        keep &= ~inside
    return p[keep]


def synthetic_varied_building(seed: int = 0, num_points: int = 35_000,
                              classes=("background", "wall", "door",
                                       "window", "ceiling", "floor"),
                              voxel_scale: int = 25, max_cells: int = 3):
    """A randomized multi-room building for train/held-out generalization.

    Unlike :func:`synthetic_building` (one fixed square room), every draw
    varies: the floor-plan (a connected, possibly L/T-shaped subset of a
    cell grid — the room-polygon case the reference's offline stage
    handles via per-room ceiling/floor boxes +
    celing_floor_room_preprocessing.preprocess_cfr), per-column/row cell
    sizes, wall height, global yaw, opening placement and per-room point
    density. Ground truth matches the reference's refined GT semantics
    (reference data3d/suncg_utils/wall_preprocessing.py: walls
    cropped at intersections -> short segments; one ceiling + one floor
    slab PER ROOM, not a building-envelope slab).

    Point sampling is visibility-culled (see :func:`_face_points`): only
    faces adjacent to an active room are scanned — no points on the
    outside of exterior walls, undersides of floors, or tops of ceilings.
    """
    rng = np.random.RandomState(seed)
    t = 0.095
    nx = rng.randint(2, max_cells + 1)
    ny = rng.randint(2, max_cells + 1)
    col_w = rng.uniform(3.5, 6.5, nx)
    row_d = rng.uniform(3.5, 6.5, ny)
    xs = np.concatenate([[0.0], np.cumsum(col_w)])
    ys = np.concatenate([[0.0], np.cumsum(row_d)])
    wall_h = rng.uniform(2.4, 3.2)
    gyaw = rng.uniform(-np.pi / 4, np.pi / 4)

    # connected active-cell subset (L/T plans)
    n_cells = nx * ny
    n_active = rng.randint(max(2, n_cells - 4), n_cells + 1)
    active = {(rng.randint(nx), rng.randint(ny))}
    while len(active) < n_active:
        cx, cy = list(active)[rng.randint(len(active))]
        dx, dy = [(1, 0), (-1, 0), (0, 1), (0, -1)][rng.randint(4)]
        nxt = (cx + dx, cy + dy)
        if 0 <= nxt[0] < nx and 0 <= nxt[1] < ny:
            active.add(nxt)

    from detection_3d_tpu_torch.data.dataset_metas import DatasetMetas
    name2lab = DatasetMetas(classes).class_2_label
    cen_x, cen_y = xs[-1] / 2, ys[-1] / 2

    def rot(x, y):
        c, s = np.cos(gyaw), np.sin(gyaw)
        dx, dy = x - cen_x, y - cen_y
        return c * dx + s * dy, -s * dx + c * dy

    boxes_std, labels, pieces = [], [], []
    # pieces: (box_std, kind, sample_sides, openings list, density)

    def add_wall(x0, y0, x1, y1, rooms_lr, openings):
        """One wall along the segment, split into <= 2.5 m pieces
        (reference GT walls are crop-at-intersection short segments,
        wall_preprocessing.py:400-446). rooms_lr: (left_active,
        right_active) for visibility culling of the two faces."""
        length = np.hypot(x1 - x0, y1 - y0)
        along = np.arctan2(-(y1 - y0), x1 - x0)  # local x axis yaw
        n_seg = max(1, int(np.ceil(length / 2.5)))
        seg = length / n_seg
        ux, uy = (x1 - x0) / length, (y1 - y0) / length
        sides = [sd for sd, on in zip((1, -1), rooms_lr) if on]
        for i in range(n_seg):
            mx = x0 + ux * (i + 0.5) * seg
            my = y0 + uy * (i + 0.5) * seg
            cxr, cyr = rot(mx, my)
            b = [cxr, cyr, wall_h / 2, seg, t, wall_h,
                 (along + gyaw) % np.pi]
            boxes_std.append(b)
            labels.append(name2lab["wall"])
            pieces.append((np.array(b, np.float32), "wall", sides,
                           openings, 1.0))

    def opening_box(x0, y0, x1, y1, frac, width, zc, height, label):
        length = np.hypot(x1 - x0, y1 - y0)
        along = np.arctan2(-(y1 - y0), x1 - x0)
        ux, uy = (x1 - x0) / length, (y1 - y0) / length
        pos = frac * length
        mx, my = x0 + ux * pos, y0 + uy * pos
        cxr, cyr = rot(mx, my)
        b = [cxr, cyr, zc, width, t * 1.5, height, (along + gyaw) % np.pi]
        boxes_std.append(b)
        labels.append(label)
        return np.array(b, np.float32)

    # unique wall edges of the active-cell grid
    ext_walls = []
    edges = []   # (x0, y0, x1, y1, left_cell, right_cell)
    for i in range(nx + 1):
        for j in range(ny):
            l = (i - 1, j) in active
            r = (i, j) in active
            if l or r:
                edges.append((xs[i], ys[j], xs[i], ys[j + 1], l, r))
    for j in range(ny + 1):
        for i in range(nx):
            l = (i, j) in active      # cell above
            r = (i, j - 1) in active  # cell below
            if l or r:
                edges.append((xs[i], ys[j], xs[i + 1], ys[j], l, r))

    for x0, y0, x1, y1, l, r in edges:
        openings = []
        length = np.hypot(x1 - x0, y1 - y0)
        if l and r:
            # interior wall: a connecting door
            ob = opening_box(x0, y0, x1, y1, rng.uniform(0.25, 0.75),
                             0.9, 1.0, 2.0, name2lab["door"])
            openings.append(ob)
            pieces.append((ob, "door", (1, -1), [], 1.0))
        else:
            ext_walls.append((x0, y0, x1, y1, l, r, length))
        add_wall(x0, y0, x1, y1, (l, r), openings)

    # exterior openings: one entrance door + windows (p=0.6, wide walls)
    if ext_walls:
        k = rng.randint(len(ext_walls))
        for idx, (x0, y0, x1, y1, l, r, length) in enumerate(ext_walls):
            side = (1,) if l else (-1,)
            if idx == k:
                ob = opening_box(x0, y0, x1, y1, rng.uniform(0.3, 0.7),
                                 0.9, 1.0, 2.0, name2lab["door"])
                pieces.append((ob, "door", side, [], 1.0))
                _attach_opening(pieces, ob)
            elif length > 3.0 and rng.rand() < 0.6:
                ob = opening_box(x0, y0, x1, y1, rng.uniform(0.3, 0.7),
                                 rng.uniform(0.9, 1.5), 1.5,
                                 rng.uniform(0.8, 1.2),
                                 name2lab["window"])
                pieces.append((ob, "window", side, [], 1.0))
                _attach_opening(pieces, ob)

    # per-room ceiling + floor slabs (NOT the building envelope): the
    # refined-GT shape celing_floor_room_preprocessing.py validates
    for (i, j) in sorted(active):
        cx = (xs[i] + xs[i + 1]) / 2
        cy = (ys[j] + ys[j + 1]) / 2
        sx_, sy_ = col_w[i], row_d[j]
        cxr, cyr = rot(cx, cy)
        dens = rng.uniform(0.6, 1.4)
        fl = [cxr, cyr, 0.06, sx_, sy_, 0.12, gyaw % np.pi]
        ce = [cxr, cyr, wall_h - 0.06, sx_, sy_, 0.12, gyaw % np.pi]
        boxes_std.append(fl)
        labels.append(name2lab["floor"])
        pieces.append((np.array(fl, np.float32), "floor", (1,), [], dens))
        boxes_std.append(ce)
        labels.append(name2lab["ceiling"])
        pieces.append((np.array(ce, np.float32), "ceiling", (-1,), [],
                       dens))

    boxes_std = np.array(boxes_std, np.float32)
    labels = np.array(labels, np.int32)

    # sample faces proportional to area x density
    areas = np.array([max(b[3] * b[5], b[3] * b[4]) * len(sides) * d
                      for b, _, sides, _, d in pieces])
    weights = areas / areas.sum()
    pts = []
    for (b, kind, sides, openings, dens), w in zip(pieces, weights):
        n = max(int(w * num_points), 8)
        for sd in sides:
            p = _face_points(rng, b[:3], b[3:6], b[6],
                             max(n // len(sides), 4), sd)
            if kind == "wall":
                p = _cut_openings(p, openings)
            pts.append(p)
    pts = np.concatenate(pts, 0).astype(np.float32)
    pts += rng.normal(0, 0.004, pts.shape).astype(np.float32)

    color = rng.uniform(0, 1, (pts.shape[0], 3)).astype(np.float32)
    nrm = rng.normal(size=(pts.shape[0], 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-9
    feats = np.concatenate([pts, color, nrm], axis=1)

    scaled = pts * voxel_scale
    shift = scaled.min(0)
    scaled = scaled - shift

    boxes_shifted = boxes_std.copy()
    boxes_shifted[:, :3] -= shift / voxel_scale
    gt_yx_zb = standard_to_yx_zb_np(boxes_shifted)
    sym = [name2lab[n] for n in ("ceiling", "floor") if n in name2lab]
    gt_yx_zb = _canonicalize_symmetric(gt_yx_zb, labels, sym)
    return {"points": scaled.astype(np.float32), "feats": feats,
            "gt_boxes": gt_yx_zb.astype(np.float32), "gt_labels": labels,
            "n_rooms": len(active)}


def _canonicalize_symmetric(yx_zb, labels, sym_labels):
    """set_yaw_zero semantics for ROTATED buildings.

    The reference's data prep zeroes the yaw of symmetric classes
    (ceiling/floor/room) whose yaw is a multiple of pi/2, swapping sizes
    for odd quarter turns (suncg_utils/suncg_dataset.py:109,
    bbox3d_ops.py set_yaw_zero; mirrored for real data in
    data/suncg._set_yaw_zero). A globally-rotated building has slab yaws
    of gyaw - pi/2 — without the quarter-turn re-expression the RPN yaw
    gate (|dif| <= 0.7, matcher.py yaw_diff_constrain) kills every slab
    anchor and slabs survive on low-quality rescue alone. Generalize:
    wrap the yaw into (-pi/4, pi/4] by quarter turns, swapping the xy
    sizes on odd turns — a lossless re-expression of the same box.
    """
    b = np.asarray(yx_zb).copy()
    lab = np.asarray(labels)
    if b.shape[0] == 0 or not sym_labels:
        return b
    sel = np.isin(lab, np.asarray(sym_labels, lab.dtype))
    yaw = b[:, 6]
    k = np.round(yaw / (np.pi / 2)).astype(int)
    new_yaw = yaw - k * (np.pi / 2)
    swap = sel & (k % 2 != 0)
    y_sz, x_sz = b[:, 3].copy(), b[:, 4].copy()
    b[swap, 3], b[swap, 4] = x_sz[swap], y_sz[swap]
    b[sel, 6] = new_yaw[sel]
    return b


def _attach_opening(pieces, ob):
    """Register an opening box with every wall piece it overlaps so the
    wall's sampled points get the hole cut."""
    for b, kind, _, openings, _ in pieces:
        if kind != "wall":
            continue
        if np.hypot(*(b[:2] - ob[:2])) < (b[3] + ob[3]) / 2 + 0.1 and \
                abs((b[6] - ob[6] + np.pi / 2) % np.pi - np.pi / 2) < 0.1:
            openings.append(ob)


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
