"""Offline ground-truth refinement: wall merge/crop/dedup, opening
alignment, ceiling/floor generation.

The port's copy of detection_3d_tpu/data/gt_preprocess.py (numpy host
code), with the two calls into the JAX package's ops replaced by the
port's: the wall-pair IoU by ops/rotated_iou.rotated_iou_pair and the
wall corners by ops/geometry.box3d_corners, both plain torch on the
CPU.

Parity targets (all host-side numpy — this is the reference's offline
data-generation stage, not the device compute path):
  * preprocess_walls pipeline —
    the reference data3d/suncg_utils/wall_preprocessing.py:12-66:
    direction normalization -> merge pieces along Y -> merge along X ->
    crop at centerline intersections -> merge along Y again -> dedup
    close walls;
  * merge_2pieces_of_1wall thresholds (wall_preprocessing.py:69-190);
  * crop_walls via centerline intersections not on corners
    (wall_preprocessing.py:400-446; Bbox3D.all_intersections_by_cenline
    with x_size_expand=0.08);
  * find_close_walls containment dedup (wall_preprocessing.py:470-525);
  * window/door correction: snap to the host wall's yaw, thickness 0.175,
    diagonal-derived length (window_preprocessing.py:10-33,
    correct_bad_windows);
  * per-room ceiling/floor slabs recovered from the wall centerlines
    (rooms_from_walls: cell-grid partition + outside flood-fill +
    rectangle decomposition; validated by the preprocess_cfr twin of
    celing_floor_room_preprocessing.py:8-97).

All boxes are STANDARD format [xc, yc, zc, x_size, y_size, z_size, yaw]
with x_size >= y_size and yaw in [0, pi).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from detection_3d_tpu_torch.ops.geometry import box3d_corners
from detection_3d_tpu_torch.ops.rotated_iou import rotated_iou_pair

MERGE_Z_ANYWAY_XYIOU_THRESHOLD = 0.75


# --------------------------------------------------------------------------
# small geometry helpers (numpy twins of utils3d/geometric_util.py)
# --------------------------------------------------------------------------

def limit_period_np(val, offset, period):
    return val - np.floor(val / period + offset) * period


def ave_angles(a0, a1):
    """Average two yaw angles in (-pi/2, pi/2] accounting for wrap
    (geometric_util.ave_angles scope_id=1 semantics)."""
    dif = limit_period_np(a1 - a0, 0.5, np.pi)
    return limit_period_np(a0 + dif / 2, 0.5, np.pi)


def centroid_line(box, axis: str = "X"):
    """Endpoints of the box centroid line along its local x (or y) axis.
    Returns (2, 3). (Bbox3D.bboxes_centroid_lines)"""
    c, s = np.cos(box[6]), np.sin(box[6])
    if axis == "X":
        d = np.array([c, -s, 0.0]) * box[3] * 0.5
    else:
        d = np.array([s, c, 0.0]) * box[4] * 0.5
    cen = box[:3]
    return np.stack([cen - d, cen + d], 0)


def vertical_dis_point_line(p, line):
    """Distance from point to the (infinite) 2D line through line[0:2]."""
    a, b = line[0][:2], line[1][:2]
    ab = b - a
    n = np.linalg.norm(ab)
    if n < 1e-9:
        return np.linalg.norm(p[:2] - a)
    return abs(np.cross(ab, p[:2] - a)) / n


def cenline_intersection_2d(box_i, box_j, x_size_expand=0.08,
                            corner_tol=0.1):
    """Intersection point of two walls' centroid lines, if it lies on both
    segments (with x_size expanded); classify whether it sits on box_i's
    corner. Returns (point (3,) or None, on_corner_i: bool).
    (Bbox3D.cenline_intersection semantics.)"""
    li = centroid_line(_expand_x(box_i, x_size_expand))
    lj = centroid_line(_expand_x(box_j, x_size_expand))
    p1, p2 = li[0][:2], li[1][:2]
    p3, p4 = lj[0][:2], lj[1][:2]
    d1 = p2 - p1
    d2 = p4 - p3
    denom = np.cross(d1, d2)
    if abs(denom) < 1e-9:
        return None, False
    t = np.cross(p3 - p1, d2) / denom
    u = np.cross(p3 - p1, d1) / denom
    if not (0.0 <= t <= 1.0 and 0.0 <= u <= 1.0):
        return None, False
    pt2 = p1 + t * d1
    z = box_i[2]
    # on-corner test vs the *unexpanded* box_i ends
    li0 = centroid_line(box_i)
    dis_ends = min(np.linalg.norm(pt2 - li0[0][:2]),
                   np.linalg.norm(pt2 - li0[1][:2]))
    on_corner = dis_ends < corner_tol + x_size_expand
    return np.array([pt2[0], pt2[1], z]), on_corner


def _expand_x(box, e):
    b = box.copy()
    b[3] += e
    return b


# --------------------------------------------------------------------------
# wall direction normalization
# --------------------------------------------------------------------------

def define_walls_direction(boxes):
    """x_size >= y_size (swap + rotate yaw by pi/2 otherwise), yaw wrapped
    to [0, pi) (Bbox3D.define_walls_direction for standard boxes)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7).copy()
    swap = boxes[:, 3] < boxes[:, 4]
    xs = boxes[:, 3].copy()
    boxes[swap, 3] = boxes[swap, 4]
    boxes[swap, 4] = xs[swap]
    boxes[swap, 6] += np.pi / 2
    boxes[:, 6] = limit_period_np(boxes[:, 6], 0.0, np.pi)
    return boxes


# --------------------------------------------------------------------------
# merging
# --------------------------------------------------------------------------

def merge_2pieces_of_1wall(bbox0, bbox1, dim: str):
    """Merge two colinear (dim='X') or stacked (dim='Y') wall pieces.
    Returns merged (7,) or None. Thresholds follow
    wall_preprocessing.py:69-190."""
    b0 = np.asarray(bbox0, np.float64).reshape(7).copy()
    b1 = np.asarray(bbox1, np.float64).reshape(7).copy()
    d = 0 if dim == "X" else 1
    dif = b1 - b0
    dif[6] = limit_period_np(dif[6], 0.5, np.pi)

    so_tol = 0.05 if d == 0 else 0.15
    so_same = abs(dif[3 + 1 - d]) < so_tol
    z_same = abs(dif[2]) < 0.01 and abs(dif[5]) < 0.01
    if not z_same:
        z0min, z0max = b0[2] - b0[5] / 2, b0[2] + b0[5] / 2
        z1min, z1max = b1[2] - b1[5] / 2, b1[2] + b1[5] / 2
        z_same = abs(z1min - z0min) < 0.01 and abs(z1max - z0max) < 0.03
        if z_same or _xy_iou(b0, b1) > MERGE_Z_ANYWAY_XYIOU_THRESHOLD:
            z_same = True
            zmin, zmax = min(z0min, z1min), max(z0max, z1max)
            for b in (b0, b1):
                b[2] = (zmin + zmax) / 2
                b[5] = zmax - zmin
    yaw_same = abs(dif[6]) < 0.05
    if not (z_same and so_same and yaw_same):
        return None

    if d == 0:
        # colinear check: b1 center close to b0's centroid line, and the
        # pieces overlap/abut along x
        dis01 = vertical_dis_point_line(b1[:3], centroid_line(b0))
        if dis01 >= b0[4] * 0.51 + 0.01:
            return None
        cen_dis = np.linalg.norm(dif[:3])
        if cen_dis >= (b0[3] + b1[3]) * 0.5 + 0.01:
            return None

    line1 = centroid_line(b1, "Y" if d == 0 else "X")
    cen_dis = vertical_dis_point_line(b0[:3], line1)
    s0, s1 = b0[3 + d], b1[3 + d]
    if s1 * 0.5 > cen_dis + s0 * 0.5:
        return b1
    if s0 * 0.5 > cen_dis + s1 * 0.5:
        return b0
    k = s1 / (s0 + s1)
    merged = (b0 + b1) / 2
    merged[6] = ave_angles(b0[6], b1[6])
    merged[:3] = b0[:3] + (b1[:3] - b0[:3]) * k
    merged[3 + d] = (s0 + s1) / 2 + cen_dis
    return merged


def _xy_iou(b0, b1):
    q = torch.tensor([b0[0], b0[1], b0[3], b0[4], b0[6]],
                     dtype=torch.float32)
    b = torch.tensor([b1[0], b1[1], b1[3], b1[4], b1[6]],
                     dtype=torch.float32)
    return float(rotated_iou_pair(q, b, -1))


def _corner_intersection_counts(walls):
    n = walls.shape[0]
    counts = np.zeros(n, np.int64)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            pt, on_corner = cenline_intersection_2d(walls[i], walls[j])
            if pt is not None and on_corner:
                counts[i] += 1
    return counts


def merge_pieces_of_same_walls_along_x(walls):
    """Merge candidate walls (fewer than 2 corner intersections) pairwise
    along X (wall_preprocessing.py:192-247)."""
    if walls.shape[0] == 0:
        return walls
    walls = walls.copy()
    counts = _corner_intersection_counts(walls)
    cand = np.where(counts < 2)[0]
    keep = np.ones(walls.shape[0], bool)
    for ii in range(len(cand) - 1):
        i = cand[ii]
        if not keep[i]:
            continue
        for jj in range(ii + 1, len(cand)):
            j = cand[jj]
            merged = merge_2pieces_of_1wall(walls[i], walls[j], "X")
            if merged is not None:
                keep[i] = False
                walls[j] = merged
                break
    return walls[keep]


def merge_pieces_of_same_walls_along_y(walls):
    """Merge parallel overlapping pieces along thickness
    (wall_preprocessing.py:249-330, the equal-length branch; the
    split-then-merge branch falls back to dropping the short piece)."""
    if walls.shape[0] == 0:
        return walls
    walls = walls.copy()
    n = walls.shape[0]
    keep = np.ones(n, bool)
    for i in range(n - 1):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if not keep[j]:
                continue
            ang = abs(limit_period_np(walls[i, 6] - walls[j, 6], 0.5, np.pi))
            if ang >= 7 * np.pi / 180:
                continue
            li = centroid_line(walls[i])
            lj = centroid_line(walls[j])
            end_dis = min(np.linalg.norm(li[a][:2] - lj[b][:2])
                          for a in range(2) for b in range(2))
            if end_dis >= (walls[i, 4] + walls[j, 4]) * 0.5:
                continue
            cen_dis = np.linalg.norm(walls[i, :3] - walls[j, :3])
            if cen_dis >= (walls[i, 3] + walls[j, 3]) * 0.45 - 0.1:
                continue
            vd = (vertical_dis_point_line(li[0], lj)
                  + vertical_dis_point_line(li[1], lj)) / 2
            thick = (walls[i, 4] + walls[j, 4]) * 0.5
            rate = vd / max(thick, 1e-9)
            if not (0.2 < rate < 1.2):
                continue
            size_rate = walls[i, 3] / max(walls[j, 3], 1e-9)
            if abs(size_rate - 1) < 0.15:
                merged = merge_2pieces_of_1wall(walls[i], walls[j], "Y")
                if merged is not None:
                    walls[j] = merged
                    keep[i] = False
                    break
            else:
                # simplified split-and-merge: keep the longer wall
                short = i if walls[i, 3] < walls[j, 3] else j
                keep[short] = False
                if short == i:
                    break
    return walls[keep]


# --------------------------------------------------------------------------
# cropping + dedup
# --------------------------------------------------------------------------

def split_wall_at_points(wall, points):
    """Split a wall at centerline points (projections along local x).
    (Bbox3D.split_wall_by_centroid_intersections)"""
    line = centroid_line(wall)
    d = line[1] - line[0]
    length = np.linalg.norm(d[:2])
    u = d / max(length, 1e-9)
    ts = sorted(float(np.dot(p[:2] - line[0][:2], u[:2])) for p in points)
    cuts = [0.0] + [t for t in ts if 0.05 < t < length - 0.05] + [length]
    out = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        if b - a < 0.06:
            continue
        piece = wall.copy()
        piece[:3] = line[0] + u * (a + b) / 2
        piece[2] = wall[2]
        piece[3] = b - a
        out.append(piece)
    return np.array(out).reshape(-1, 7)


def crop_walls(walls):
    """Split walls at centerline intersections away from corners
    (wall_preprocessing.py:400-446)."""
    if walls.shape[0] == 0:
        return walls
    n = walls.shape[0]
    keep = np.ones(n, bool)
    new_walls = []
    for i in range(n):
        pts = []
        for j in range(n):
            if i == j:
                continue
            pt, on_corner = cenline_intersection_2d(walls[i], walls[j])
            if pt is not None and not on_corner:
                if all(np.linalg.norm(pt[:2] - q[:2]) >= 4e-2 for q in pts):
                    pts.append(pt)
        if pts:
            pieces = split_wall_at_points(walls[i], pts)
            if pieces.shape[0] > 1:
                keep[i] = False
                new_walls.append(pieces)
    walls = walls[keep]
    if new_walls:
        walls = np.concatenate([walls] + new_walls, 0)
    return walls


def find_close_walls(walls):
    """Containment-based dedup (wall_preprocessing.py:470-525): if two
    walls contain each other, average-merge; if one is inside the other,
    drop the inner one."""
    n = walls.shape[0]
    if n == 0:
        return walls
    walls = walls.copy()

    def inside(i, j):
        # wall i inside wall j: i's centroid-line ends near j's line and
        # within j's extent
        li = centroid_line(walls[i])
        lj = centroid_line(walls[j])
        vd = max(vertical_dis_point_line(li[0], lj),
                 vertical_dis_point_line(li[1], lj))
        if vd >= walls[j, 4] * 0.8 + 0.03:
            return False
        d = lj[1][:2] - lj[0][:2]
        L = np.linalg.norm(d)
        u = d / max(L, 1e-9)
        for end in li:
            t = np.dot(end[:2] - lj[0][:2], u)
            if t < -0.05 or t > L + 0.05:
                return False
        return True

    keep = np.ones(n, bool)
    for i in range(n - 1):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if not keep[j]:
                continue
            in_ij, in_ji = inside(i, j), inside(j, i)
            if in_ij and in_ji:
                m = (walls[i] + walls[j]) / 2
                m[6] = ave_angles(walls[i, 6], walls[j, 6])
                m[3:6] = np.maximum(walls[i, 3:6], walls[j, 3:6])
                walls[j] = m
                keep[i] = False
                break
            if in_ij:
                keep[i] = False
                break
            if in_ji:
                keep[j] = False
    return walls[keep]


def preprocess_walls(wall_bboxes):
    """Full wall-refinement pipeline (wall_preprocessing.py:12-66)."""
    walls = np.asarray(wall_bboxes, np.float64).reshape(-1, 7)
    if walls.shape[0] == 0:
        return walls
    walls = define_walls_direction(walls)
    walls = merge_pieces_of_same_walls_along_y(walls)
    walls = merge_pieces_of_same_walls_along_x(walls)
    walls = crop_walls(walls)
    walls = merge_pieces_of_same_walls_along_y(walls)
    walls = find_close_walls(walls)
    return walls


# --------------------------------------------------------------------------
# openings (windows / doors) + slabs
# --------------------------------------------------------------------------

def _host_wall_ids(openings, walls):
    """Wall whose footprint contains each opening centroid; -1 if none."""
    ids = np.full(openings.shape[0], -1, np.int64)
    for i, op in enumerate(openings):
        best, best_d = -1, np.inf
        for j, w in enumerate(walls):
            line = centroid_line(w)
            vd = vertical_dis_point_line(op[:3], line)
            d = line[1][:2] - line[0][:2]
            L = np.linalg.norm(d)
            t = np.dot(op[:2] - line[0][:2], d / max(L, 1e-9))
            if vd < w[4] * 0.5 + 0.3 and -0.2 <= t <= L + 0.2 and vd < best_d:
                best, best_d = j, vd
        ids[i] = best
    return ids


def preprocess_openings(openings, walls, thickness: float = 0.175):
    """Align windows/doors to host walls (window_preprocessing.py:10-33 +
    correct_bad_windows): misaligned openings adopt the wall's yaw, a
    fixed thickness, and a diagonal-corrected length."""
    ops = define_walls_direction(openings)
    if ops.shape[0] == 0 or walls.shape[0] == 0:
        return ops
    hosts = _host_wall_ids(ops, walls)
    for i, h in enumerate(hosts):
        if h < 0:
            continue
        yaw_dif = abs(limit_period_np(ops[i, 6] - walls[h, 6], 0.5, np.pi))
        if yaw_dif < 0.05 and ops[i, 4] <= 0.3:
            continue  # already aligned and thin
        diag = np.sqrt(ops[i, 3] ** 2 + ops[i, 4] ** 2)
        ops[i, 6] = walls[h, 6]
        ops[i, 4] = thickness
        yaws = limit_period_np(walls[h, 6], 0.0, np.pi / 2)
        ops[i, 3] = diag - thickness * np.sin(2 * yaws)
    ops[:, 6] = limit_period_np(ops[:, 6], 0.0, np.pi)
    return ops


preprocess_windows = preprocess_openings
preprocess_doors = preprocess_openings


def _cluster_cuts(vals, tol):
    """Sorted cluster means of 1D positions (gap > tol splits)."""
    if vals.size == 0:
        return np.zeros((0,))
    vals = np.sort(vals)
    cuts, group = [], [vals[0]]
    for v in vals[1:]:
        if v - group[-1] > tol:
            cuts.append(np.mean(group))
            group = [v]
        else:
            group.append(v)
    cuts.append(np.mean(group))
    return np.asarray(cuts)


def rooms_from_walls(walls, tol: float = 0.3, block_frac: float = 0.5):
    """Per-room xy rectangles from wall centerlines — the GENERATIVE
    counterpart of :func:`preprocess_cfr` for houses whose room nodes
    carry no ceiling/floor candidates. The reference always has one
    SUNCG slab per room to validate (celing_floor_room_preprocessing.py:
    8-97); when none exist we reconstruct the rooms:

      1. rotate wall centerlines by the dominant wall yaw (circular
         mean with period pi/2) so the plan is axis-aligned;
      2. cluster wall positions into x/y grid cuts -> a cell grid;
      3. a cell edge is blocked when a wall centerline covers more than
         ``block_frac`` of it; flood-fill marks every cell that can
         reach the grid boundary through unblocked edges as OUTSIDE
         (this carves L/T-shaped plans out of their bounding envelope);
      4. rooms = connected components of the interior cells; each room
         is greedily decomposed into maximal rectangles (one per
         rectangular room).

    Returns (R, 7) standard boxes with z-center/size_z = 0 and the
    dominant yaw; (0, 7) when no enclosed room is found.
    """
    empty = np.zeros((0, 7))
    if walls.shape[0] < 4:
        return empty
    cl = np.stack([centroid_line(w, "X") for w in np.asarray(
        walls, np.float64)])                     # (W, 2, 3)
    yaws = np.asarray(walls, np.float64)[:, 6]
    theta = np.arctan2(np.sin(4 * yaws).mean(),
                       np.cos(4 * yaws).mean()) / 4
    c, s = np.cos(theta), np.sin(theta)
    # yaw rotates geometry CLOCKWISE in this codebase (a yaw-theta wall
    # runs along (cos theta, -sin theta), see centroid_line); the work
    # frame rotates the plan back to axis-aligned
    R = np.array([[c, -s], [s, c]])
    p0 = cl[:, 0, :2] @ R.T
    p1 = cl[:, 1, :2] @ R.T
    d = p1 - p0
    vert = np.abs(d[:, 0]) < tol       # constant-x walls
    horz = np.abs(d[:, 1]) < tol
    xcuts = _cluster_cuts((p0[vert, 0] + p1[vert, 0]) / 2, tol)
    ycuts = _cluster_cuts((p0[horz & ~vert, 1]
                           + p1[horz & ~vert, 1]) / 2, tol)
    nx, ny = len(xcuts) - 1, len(ycuts) - 1
    if nx < 1 or ny < 1:
        return empty

    # blocked[axis] edges: vx[i, j] between cells (i-1, j)|(i, j);
    # vy[i, j] between cells (i, j-1)|(i, j)
    vx = np.zeros((nx + 1, ny), bool)
    vy = np.zeros((nx, ny + 1), bool)
    for w in np.where(vert)[0]:
        wx = (p0[w, 0] + p1[w, 0]) / 2
        i = int(np.argmin(np.abs(xcuts - wx)))
        if abs(xcuts[i] - wx) > tol:
            continue
        lo, hi = sorted((p0[w, 1], p1[w, 1]))
        for j in range(ny):
            ov = min(hi, ycuts[j + 1]) - max(lo, ycuts[j])
            if ov > block_frac * (ycuts[j + 1] - ycuts[j]):
                vx[i, j] = True
    for w in np.where(horz & ~vert)[0]:
        wy = (p0[w, 1] + p1[w, 1]) / 2
        j = int(np.argmin(np.abs(ycuts - wy)))
        if abs(ycuts[j] - wy) > tol:
            continue
        lo, hi = sorted((p0[w, 0], p1[w, 0]))
        for i in range(nx):
            ov = min(hi, xcuts[i + 1]) - max(lo, xcuts[i])
            if ov > block_frac * (xcuts[i + 1] - xcuts[i]):
                vy[i, j] = True

    # flood-fill the outside through unblocked edges
    outside = np.zeros((nx, ny), bool)
    stack = []
    for j in range(ny):
        if not vx[0, j]:
            stack.append((0, j))
        if not vx[nx, j]:
            stack.append((nx - 1, j))
    for i in range(nx):
        if not vy[i, 0]:
            stack.append((i, 0))
        if not vy[i, ny]:
            stack.append((i, ny - 1))
    while stack:
        i, j = stack.pop()
        if outside[i, j]:
            continue
        outside[i, j] = True
        if i > 0 and not vx[i, j] and not outside[i - 1, j]:
            stack.append((i - 1, j))
        if i < nx - 1 and not vx[i + 1, j] and not outside[i + 1, j]:
            stack.append((i + 1, j))
        if j > 0 and not vy[i, j] and not outside[i, j - 1]:
            stack.append((i, j - 1))
        if j < ny - 1 and not vy[i, j + 1] and not outside[i, j + 1]:
            stack.append((i, j + 1))

    # rooms: components of interior cells over unblocked edges
    room_id = np.full((nx, ny), -1, np.int64)
    n_rooms = 0
    for i0 in range(nx):
        for j0 in range(ny):
            if outside[i0, j0] or room_id[i0, j0] >= 0:
                continue
            stack = [(i0, j0)]
            while stack:
                i, j = stack.pop()
                if room_id[i, j] >= 0 or outside[i, j]:
                    continue
                room_id[i, j] = n_rooms
                if i > 0 and not vx[i, j]:
                    stack.append((i - 1, j))
                if i < nx - 1 and not vx[i + 1, j]:
                    stack.append((i + 1, j))
                if j > 0 and not vy[i, j]:
                    stack.append((i, j - 1))
                if j < ny - 1 and not vy[i, j + 1]:
                    stack.append((i, j + 1))
            n_rooms += 1

    # greedy maximal-rectangle decomposition per room
    Rinv = np.array([[c, s], [-s, c]])
    rects = []
    for r in range(n_rooms):
        todo = room_id == r
        while todo.any():
            i0, j0 = np.argwhere(todo)[0]
            i1 = i0
            while i1 + 1 < nx and todo[i1 + 1, j0]:
                i1 += 1
            j1 = j0
            while j1 + 1 < ny and todo[i0:i1 + 1, j1 + 1].all():
                j1 += 1
            todo[i0:i1 + 1, j0:j1 + 1] = False
            x0, x1 = xcuts[i0], xcuts[i1 + 1]
            y0, y1 = ycuts[j0], ycuts[j1 + 1]
            cen = np.array([(x0 + x1) / 2, (y0 + y1) / 2]) @ Rinv.T
            rects.append([cen[0], cen[1], 0.0, x1 - x0, y1 - y0, 0.0,
                          limit_period_np(theta, 0.0, np.pi)])
    return np.asarray(rects) if rects else empty


def make_ceiling_floor(walls, thickness: float = 0.12):
    """Per-room ceiling + floor slabs from the wall centerlines
    (:func:`rooms_from_walls`); one slab pair per rectangular room piece
    — the refined-GT shape preprocess_cfr validates
    (celing_floor_room_preprocessing.py:8-97). Falls back to one
    envelope pair when no enclosed room is recovered."""
    if walls.shape[0] == 0:
        return np.zeros((0, 7)), np.zeros((0, 7))
    # float32, as the JAX package's copy computes them
    corners = box3d_corners(torch.as_tensor(np.asarray(walls),
                                            dtype=torch.float32)) \
        .numpy().reshape(-1, 3)
    mn, mx = corners.min(0), corners.max(0)
    rooms = rooms_from_walls(np.asarray(walls, np.float64))
    if rooms.shape[0] == 0:
        cx, cy = (mn[0] + mx[0]) / 2, (mn[1] + mx[1]) / 2
        rooms = np.array([[cx, cy, 0.0, mx[0] - mn[0], mx[1] - mn[1],
                           0.0, 0.0]])
    floor = rooms.copy()
    floor[:, 2] = mn[2] + thickness / 2
    floor[:, 5] = thickness
    ceiling = rooms.copy()
    ceiling[:, 2] = mx[2] - thickness / 2
    ceiling[:, 5] = thickness
    return define_walls_direction(ceiling), define_walls_direction(floor)


# ---- per-room ceiling/floor validation (preprocess_cfr) -------------------
# Re-derivation of the reference data3d/suncg_utils/
# celing_floor_room_preprocessing.py:8-200: SUNCG rooms come with one
# ceiling/floor slab each; a candidate is kept when it (a) is not a
# duplicate, (b) does not cover more than one other candidate (multi-room
# envelope slabs are rejected), and (c) is supported by >= 3 edge walls
# (or 2 walls that each touch with both corners AND centroid).


def _box_corners_2d(box):
    """(4, 3) xy corners at z=0 of a standard box."""
    c, s = np.cos(box[6]), np.sin(box[6])
    R = np.array([[c, s], [-s, c]])
    half = np.array([[0.5, 0.5], [0.5, -0.5], [-0.5, -0.5], [-0.5, 0.5]])
    xy = (half * box[3:5]) @ R + box[:2]
    out = np.zeros((4, 3))
    out[:, :2] = xy
    return out


def _point_to_segment_info(points, line):
    """For (n,3) points vs one segment (2,3): (perp_dis, on_segment)."""
    a, b = line[0][:2], line[1][:2]
    ab = b - a
    nrm = np.linalg.norm(ab)
    p = points[:, :2]
    if nrm < 1e-9:
        d = np.linalg.norm(p - a, axis=1)
        return d, d
    perp = np.abs((p - a)[:, 0] * ab[1] - (p - a)[:, 1] * ab[0]) / nrm
    t = ((p - a) @ ab) / (nrm * nrm)
    end_dis = np.minimum(np.linalg.norm(p - a, axis=1),
                         np.linalg.norm(p - b, axis=1))
    return perp, np.where((t >= 0) & (t <= 1), 0.0, end_dis)


def points_in_lines(points, lines, threshold_dis=0.03):
    """(n, m) bool: point lies ON segment (within threshold_dis) —
    geometric_util.points_in_lines semantics (perpendicular distance AND
    inside the segment extent or within threshold of an endpoint)."""
    n, m = points.shape[0], lines.shape[0]
    out = np.zeros((n, m), bool)
    for j in range(m):
        perp, extent = _point_to_segment_info(points, lines[j])
        out[:, j] = (perp < threshold_dis) & (extent < threshold_dis)
    return out


def is_extend_lines(lines0, lines1, threshold_dis=0.03):
    """(n, m) bool: both endpoints of line i within threshold of the
    infinite line through line j (collinear) —
    geometric_util.is_extend_lines."""
    n, m = lines0.shape[0], lines1.shape[0]
    out = np.zeros((n, m), bool)
    for i in range(n):
        for j in range(m):
            d0 = vertical_dis_point_line(lines0[i, 0], lines1[j])
            d1 = vertical_dis_point_line(lines0[i, 1], lines1[j])
            out[i, j] = (d0 < threshold_dis) and (d1 < threshold_dis)
    return out


def _clean_repeat_cfr(ceilings):
    """Drop near-duplicate candidates (cen < 0.1 m, rel size < 0.1,
    yaw < 0.1) — celing_floor_room_preprocessing.clean_repeat."""
    n = ceilings.shape[0]
    keep = [0]
    for i in range(1, n):
        dup = False
        for j in keep:
            dif = ceilings[i] - ceilings[j]
            ref = max(ceilings[i, 3:6].max(), ceilings[j, 3:6].max())
            if (np.linalg.norm(dif[:3]) < 0.1
                    and np.abs(dif[3:6]).max() / max(ref, 1e-9) < 0.1
                    and abs(dif[6]) < 0.1):
                dup = True
                break
        if not dup:
            keep.append(i)
    return ceilings[keep], np.array(keep, np.int64)


def _edge_wall_count(wall_cenlines, ceiling):
    """#edge walls of a ceiling + per-wall in_state
    (celing_floor_room_preprocessing.is_edge_wall_of_ceiling): an edge
    wall has >= 2 of its 3 probe points (2 corners + centroid) on one of
    the ceiling's 4 boundary edges; collinear duplicates count once."""
    corners = _box_corners_2d(ceiling)
    edges = np.stack([np.stack([corners[k], corners[(k + 1) % 4]])
                      for k in range(4)])
    wn = wall_cenlines.shape[0]
    probes = np.concatenate(
        [wall_cenlines, wall_cenlines.mean(1, keepdims=True)], 1)
    in_mask = points_in_lines(probes.reshape(-1, 3), edges,
                              threshold_dis=0.1).reshape(wn, 3, 4)
    in_state = in_mask.any(2).sum(1)
    winc_ids = np.where(in_state >= 2)[0]
    if winc_ids.size == 0:
        return 0, np.zeros((0,), np.int64)
    # at most one edge wall per boundary edge (clean_extend_lines)
    lines = wall_cenlines[winc_ids]
    ext = is_extend_lines(lines, lines)
    rm = [i for i in range(len(winc_ids) - 1) if ext[i, i + 1:].any()]
    keep = [i for i in range(len(winc_ids)) if i not in rm]
    return len(keep), in_state[winc_ids[keep]]


def preprocess_cfr(ceilings, walls):
    """Keep per-room ceiling (or floor) candidates supported by walls
    (celing_floor_room_preprocessing.preprocess_cfr). Input/output:
    standard (N, 7) boxes."""
    if ceilings.shape[0] == 0:
        return ceilings
    if walls.shape[0] == 0:
        return np.zeros((0, 7), np.float32)
    ceilings_c, keep0 = _clean_repeat_cfr(np.asarray(ceilings, np.float64))
    cn = ceilings_c.shape[0]
    flat = ceilings_c.copy()
    flat[:, 2] = 0

    corners_all = np.stack([_box_corners_2d(c) for c in flat])  # (cn,4,3)
    wall_cenlines = np.stack([centroid_line(w, "X") for w in walls])
    wall_cenlines[:, :, 2] = 0

    good = []
    for c in range(cn):
        # (1) covering more than one other candidate => multi-room slab
        box_c = flat[c].copy()
        box_c[3:6] += 0.2
        inside = _corners_in_box_2d(corners_all.reshape(-1, 3), box_c)
        inside = inside.reshape(cn, 4).all(1)
        if inside.sum() - 1 > 1:
            continue
        # (2) edge-wall support
        num, state = _edge_wall_count(wall_cenlines, flat[c])
        if num >= 3 or (num == 2 and len(state) and (state == 3).all()):
            good.append(c)
    return np.asarray(ceilings)[keep0[good]]


def _corners_in_box_2d(points, box):
    """(n,) bool: xy points inside the rotated xy footprint of box."""
    c, s = np.cos(box[6]), np.sin(box[6])
    R = np.array([[c, -s], [s, c]])
    local = (points[:, :2] - box[:2]) @ R.T
    return (np.abs(local[:, 0]) <= box[3] / 2 + 1e-9) & \
           (np.abs(local[:, 1]) <= box[4] / 2 + 1e-9)
