"""Depth-render point-cloud generation: GT boxes -> cameras -> z-buffer
depth images -> back-projected, occlusion-correct point clouds.

The port's copy of detection_3d_tpu/data/depth_render.py (numpy host
code; the z-buffer stays numpy).

Numpy re-implementation of the reference's ``gen_pcl`` stage
(reference data3d/suncg_utils/suncg_preprocess.py:673-834), which
reads depth PNGs pre-rendered by the SUNCG toolbox (gaps scn2img) from
cameras generated by scn2cam, back-projects each through a pinhole model
(``depth_2_pcl``, :790-834) and voxel-downsamples the merged cloud at
2 cm. Because the raw SUNCG asset tree + renderer are not available,
this module replaces the external renderer with a software z-buffer
rasterizer over the house's box meshes, keeping the reference's camera
record format and back-projection math bit-for-bit:

  * camera record = [vx vy vz, tx ty tz, ux uy uz, xfov yfov score]
    (scn2cam layout, suncg_preprocess.py:46-57);
  * extrinsics columns [right, -up, forward | position]
    (``camPos2Extrinsics``, :61-74);
  * focus = 0.5*w / tan(xfov) (``camFocus``, :76-88);
  * pixel->ray x = (u - 0.5*w + 0.5) * depth / focus (``depth_2_pcl``,
    :790-820).

The output replaces/validates the fast box-surface sampler
(house_parser.sample_surface_points) with view-dependent density and
true occlusion — the realism gap called out for that stand-in.

Offline host-side stage (numpy): it feeds the detector.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_DEF_CATS = ("wall", "window", "door", "ceiling", "floor")


# ---------------------------------------------------------------------------
# camera records (scn2cam parity)

def make_camera(position, forward, up, xfov=0.55, yfov=None,
                hw=(120, 160), score=1.0) -> np.ndarray:
    """Build one 12-float camera record in the scn2cam layout
    (suncg_preprocess.py:46-57). ``forward``/``up`` are normalized and
    ``up`` is re-orthogonalized against ``forward``. ``yfov`` defaults to
    the value consistent with ``xfov`` at aspect ``hw`` (cam_focus
    asserts x/y focus agreement, as the reference does)."""
    if yfov is None:
        yfov = np.arctan(np.tan(xfov) * hw[0] / hw[1])
    t = np.asarray(forward, np.float64)
    t = t / np.linalg.norm(t)
    u = np.asarray(up, np.float64)
    u = u - t * np.dot(u, t)
    u = u / np.linalg.norm(u)
    return np.concatenate([np.asarray(position, np.float64), t, u,
                           [xfov, yfov, score]])


def cam_extrinsics(cam_pos: np.ndarray) -> np.ndarray:
    """Camera->world [3,4] from a scn2cam record: rotation columns are
    the camera axes (right, down=-up, forward) expressed in world frame,
    translation is the camera position — the semantics of the
    reference's camPos2Extrinsics (suncg_preprocess.py:61-74), including
    its rejection of non-orthonormal records."""
    rec = np.asarray(cam_pos, np.float64).reshape(12)
    position, forward, up = rec[:3], rec[3:6], rec[6:9]
    right = np.cross(forward, up)
    rot = np.stack([right, -up, forward], axis=1)
    if not np.allclose(rot @ rot.T, np.eye(3), atol=5e-3):
        raise ValueError("camera record axes are not orthonormal")
    return np.concatenate([rot, position[:, None]], axis=1)


def cam_focus(cam_pos: np.ndarray, resolution) -> float:
    """Focal length in pixels, f = (w/2) / tan(xfov) (camFocus,
    suncg_preprocess.py:76-88). The record's yfov must imply the same
    focal at this resolution (square pixels)."""
    h, w = resolution
    rec = np.asarray(cam_pos, np.float64).reshape(12)
    fx = 0.5 * w / np.tan(rec[9])
    fy = 0.5 * h / np.tan(rec[10])
    if abs(fx - fy) >= 1e-3 * fx:
        raise ValueError(
            f"anisotropic fovs: fx={fx:.4f} fy={fy:.4f} at {resolution}")
    return fx


def cameras_for_rooms(room_boxes: np.ndarray, n_yaw: int = 8,
                      eye_height: float = 1.5, pitch: float = -0.15,
                      xfov: float = 0.55, hw=(120, 160)) -> np.ndarray:
    """Camera generation standing in for scn2cam: for every room box
    (7-DoF, e.g. the refined floor slabs), ``n_yaw`` cameras at the room
    center, ``eye_height`` above the box bottom, looking outward with a
    slight downward pitch — the same room-interior viewpoints scn2cam
    scores highly. Returns (R*n_yaw, 12) records."""
    h, w = hw
    yfov = np.arctan(np.tan(xfov) * h / w)
    cams = []
    for b in np.asarray(room_boxes, np.float64).reshape(-1, 7):
        cx, cy, cz = b[0], b[1], b[2] - b[5] / 2 + eye_height
        for k in range(n_yaw):
            a = b[6] + 2 * np.pi * k / n_yaw
            fwd = np.array([np.cos(a) * np.cos(pitch),
                            np.sin(a) * np.cos(pitch), np.sin(pitch)])
            cams.append(make_camera([cx, cy, cz], fwd, [0.0, 0.0, 1.0],
                                    xfov, yfov))
    if not cams:
        return np.zeros((0, 12))
    return np.stack(cams)


# ---------------------------------------------------------------------------
# box meshes

_CORNER_SIGNS = np.array([[sx, sy, sz] for sx in (-.5, .5)
                          for sy in (-.5, .5) for sz in (-.5, .5)])
# 12 triangles over the 8 corners (indices into _CORNER_SIGNS order:
# bit2=x, bit1=y, bit0=z)
_BOX_TRIS = np.array([
    [0, 1, 3], [0, 3, 2],      # -x face
    [4, 7, 5], [4, 6, 7],      # +x face
    [0, 5, 1], [0, 4, 5],      # -y face
    [2, 3, 7], [2, 7, 6],      # +y face
    [0, 2, 6], [0, 6, 4],      # -z face
    [1, 5, 7], [1, 7, 3],      # +z face
])


def boxes_to_triangles(boxes: np.ndarray) -> np.ndarray:
    """7-DoF standard boxes [cx,cy,cz,sx,sy,sz,yaw] -> (T, 3, 3) world
    triangles (12 per box) — the mesh the external renderer rasterized."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    if boxes.shape[0] == 0:
        return np.zeros((0, 3, 3))
    corners = _CORNER_SIGNS[None] * boxes[:, None, 3:6]      # (B, 8, 3)
    # clockwise rotation [[c, s], [-s, c]] — the stack-wide convention
    # (rbbox_to_corners, nms_gpu.py:376-378)
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = corners[..., 0] * c[:, None] + corners[..., 1] * s[:, None]
    y = -corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    corners = np.stack([x, y, corners[..., 2]], -1) + boxes[:, None, :3]
    return corners[:, _BOX_TRIS].reshape(-1, 3, 3)            # (B*12,3,3)


# ---------------------------------------------------------------------------
# z-buffer rasterizer

def render_depth(tris: np.ndarray, cam_pos: np.ndarray,
                 hw=(120, 160), near: float = 0.05,
                 far: float = 1e4) -> np.ndarray:
    """Rasterize world triangles into a (h, w) depth image (meters along
    the camera forward axis; 0 = no hit) for one scn2cam camera record.
    Perspective-correct via screen-space-linear 1/z. This is the software
    stand-in for the gaps scn2img renderer the reference shells out to."""
    h, w = hw
    E = cam_extrinsics(cam_pos)
    R, t = E[:, :3], E[:, 3]
    f = cam_focus(cam_pos, hw)

    tris = np.asarray(tris, np.float64)
    if tris.shape[0] == 0:
        return np.zeros((h, w))
    # world -> camera: p_cam = R^T (p - t); axes (right, down, forward)
    v = np.einsum("ij,tkj->tki", R.T, tris - t)               # (T, 3, 3)
    # conservative near-plane handling: drop tris not fully in front
    keep = (v[..., 2] > near).all(1) & (v[..., 2] < far).any(1)
    v = v[keep]
    if v.shape[0] == 0:
        return np.zeros((h, w))
    inv_z = 1.0 / v[..., 2]
    # pixel centers: u = x*f/z + 0.5w - 0.5  (depth_2_pcl inverse)
    px = v[..., 0] * f * inv_z + 0.5 * w - 0.5
    py = v[..., 1] * f * inv_z + 0.5 * h - 0.5

    depth = np.full((h, w), np.inf)
    x0 = np.maximum(np.floor(px.min(1)), 0).astype(int)
    x1 = np.minimum(np.ceil(px.max(1)), w - 1).astype(int)
    y0 = np.maximum(np.floor(py.min(1)), 0).astype(int)
    y1 = np.minimum(np.ceil(py.max(1)), h - 1).astype(int)
    on = (x1 >= x0) & (y1 >= y0)
    for i in np.nonzero(on)[0]:
        ax, ay = px[i, 0], py[i, 0]
        bx, by = px[i, 1], py[i, 1]
        cx, cy = px[i, 2], py[i, 2]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(den) < 1e-12:
            continue
        gx, gy = np.meshgrid(np.arange(x0[i], x1[i] + 1),
                             np.arange(y0[i], y1[i] + 1))
        l0 = ((by - cy) * (gx - cx) + (cx - bx) * (gy - cy)) / den
        l1 = ((cy - ay) * (gx - ax) + (ax - cx) * (gy - ay)) / den
        l2 = 1.0 - l0 - l1
        eps = -1e-9
        inside = (l0 >= eps) & (l1 >= eps) & (l2 >= eps)
        if not inside.any():
            continue
        zi = 1.0 / (l0 * inv_z[i, 0] + l1 * inv_z[i, 1] + l2 * inv_z[i, 2])
        patch = depth[y0[i]:y1[i] + 1, x0[i]:x1[i] + 1]
        np.copyto(patch, zi, where=inside & (zi < patch))
    depth[~np.isfinite(depth)] = 0.0
    return depth


def depth_to_pcl(depth: np.ndarray, cam_pos: np.ndarray) -> np.ndarray:
    """Back-project a depth image to world points. Pinhole semantics of
    the reference's ``depth_2_pcl`` (suncg_preprocess.py:790-820) — ray
    through the center of pixel (u, v), principal point at the image
    center, depth measured along the forward axis — minus the color
    channels (our renderer produces geometry only)."""
    E = cam_extrinsics(cam_pos)
    rot, position = E[:, :3], E[:, 3]
    depth = np.asarray(depth, np.float64)
    h, w = depth.shape
    z = depth.reshape(-1)
    hit = z > 0
    z = z[hit]

    # camera-frame coords: x = (u - cx) * z / f with pixel-center offset
    v, u = [g.reshape(-1)[hit] for g in
            np.meshgrid(np.arange(h), np.arange(w), indexing="ij")]
    scale = z / cam_focus(cam_pos, depth.shape)
    cam_pts = np.stack([(u - 0.5 * w + 0.5) * scale,
                        (v - 0.5 * h + 0.5) * scale, z], axis=1)
    return (cam_pts @ rot.T + position).astype(np.float32)


def voxel_downsample(points: np.ndarray, voxel: float = 0.02,
                     seed: int = 0) -> np.ndarray:
    """One random representative per ``voxel`` cell — the
    open3d.voxel_down_sample(voxel_size=0.02) step of gen_pcl
    (suncg_preprocess.py:763-766)."""
    points = np.asarray(points)
    if points.shape[0] == 0:
        return points
    keys = np.floor(points[:, :3] / voxel).astype(np.int64)
    keys -= keys.min(0)
    lin = (keys[:, 0] * (keys[:, 1].max() + 1)
           + keys[:, 1]) * (keys[:, 2].max() + 1) + keys[:, 2]
    order = np.random.RandomState(seed).permutation(points.shape[0])
    _, first = np.unique(lin[order], return_index=True)
    return points[np.sort(order[first])]


# ---------------------------------------------------------------------------
# whole-house pipeline (gen_pcl parity)

def render_house_pcl(bboxes: Dict[str, np.ndarray],
                     categories=_DEF_CATS,
                     cameras: Optional[np.ndarray] = None,
                     hw=(120, 160), n_yaw: int = 8,
                     max_point_num: float = 2e7,
                     voxel: float = 0.02,
                     seed: int = 0) -> np.ndarray:
    """GT boxes -> cameras -> depth renders -> merged, voxel-downsampled
    world point cloud (the gen_pcl loop, suncg_preprocess.py:673-777:
    per-image back-projection, per-image pre-downsample to
    max_point_num/n_cams, 2 cm voxel downsample). Cameras default to
    room-interior views from the floor slabs (scn2cam stand-in)."""
    tris = boxes_to_triangles(np.concatenate(
        [np.asarray(bboxes.get(c, np.zeros((0, 7)))).reshape(-1, 7)
         for c in categories], 0))
    if cameras is None:
        rooms = np.asarray(bboxes.get("floor", np.zeros((0, 7))))
        if rooms.shape[0] == 0:          # no floors: orbit the envelope
            rooms = np.asarray(bboxes.get("wall", np.zeros((0, 7))))
            if rooms.shape[0] == 0:
                return np.zeros((0, 3), np.float32)
            lo = (rooms[:, :3] - rooms[:, 3:6] / 2).min(0)
            hi = (rooms[:, :3] + rooms[:, 3:6] / 2).max(0)
            rooms = np.concatenate([(lo + hi) / 2, hi - lo, [0.0]])[None]
        rooms = rooms.reshape(-1, 7)
        cameras = cameras_for_rooms(rooms, n_yaw=n_yaw, hw=hw)

    rng = np.random.RandomState(seed)
    pre_n = int(max_point_num / max(cameras.shape[0], 1))
    pcls = []
    for cam in cameras:
        depth = render_depth(tris, cam, hw=hw)
        pcl = depth_to_pcl(depth, cam)
        if pcl.shape[0] > pre_n:
            pcl = pcl[np.sort(rng.choice(pcl.shape[0], pre_n, False))]
        if pcl.shape[0]:
            pcls.append(pcl)
    if not pcls:
        return np.zeros((0, 3), np.float32)
    merged = np.concatenate(pcls, 0)
    return voxel_downsample(merged, voxel, seed=seed).astype(np.float32)
