"""Offline SUNCG house parser: house.json + room OBJ meshes -> GT boxes.

The port's copy of detection_3d_tpu/data/house_parser.py (numpy host
code, over the port's data/gt_preprocess.py, data/depth_render.py and
data/synthetic.py).

Geometry-only re-implementation of the reference's offline stage
(reference data3d/suncg_utils/suncg_preprocess.py:394-834):

  * ``parse_obj_parts``  — Wavefront OBJ split into named 'o' parts
    (suncg_preprocess.read_obj_parts);
  * ``part_oriented_bbox`` — oriented 7-DoF box of one mesh part from its
    8 outermost corners, with the axis-aligned fallback for
    Ceiling/Floor/Room parts (suncg_preprocess.get_part_bbox:~200);
  * ``cam2world_box`` / ``cam2world_points`` — SUNCG's Y-up camera frame
    to the Z-up world frame (suncg_preprocess.py:341-373);
  * ``parse_house`` — walk house.json levels/nodes: Object nodes become
    category boxes via the model-id map, Room nodes load their per-room
    wall/ceiling/floor meshes (suncg_preprocess.gen_bbox:550-640,
    split_room_parts:652-675);
  * ``refine_house_boxes`` — the full GT refinement chain: wall
    merge/crop, window/door alignment, per-room ceiling/floor validation
    (gen_bbox:608-616 -> data/gt_preprocess.py);
  * ``sample_surface_points`` — fast point cloud from the parsed boxes;
  * ``house_point_cloud`` — point-source dispatch: ``method="render"``
    uses data/depth_render.py (z-buffer depth images from room cameras,
    back-projected and voxel-downsampled — the gen_pcl/depth_2_pcl
    equivalent, suncg_preprocess.py:673-834, with true occlusion and
    view-dependent density), ``method="surface"`` the fast sampler.

Everything is plain numpy (offline host-side stage — this feeds the
detector, it is not on its device path).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from detection_3d_tpu_torch.data.gt_preprocess import (
    preprocess_walls, preprocess_windows, preprocess_doors, preprocess_cfr,
)

# mesh parts whose outline need not be a rectangle: fall back to the
# axis-aligned box (suncg_preprocess.py:30 ENABLE_NO_RECTANGLE)
NO_RECTANGLE_OK = ("Ceiling", "Floor", "Room")


def bbox_from_minmax(bmin, bmax) -> np.ndarray:
    """Axis-aligned 7-DoF box from min/max corners
    (utils3d/bbox3d_ops.py:509-517)."""
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    return np.concatenate([(bmin + bmax) / 2, bmax - bmin, [0.0]])


def cam2world_box(boxes: np.ndarray) -> np.ndarray:
    """SUNCG camera frame (Y up) -> world frame (Z up):
    (x, y, z) -> (x, -z, y), sizes swap y/z, yaw kept
    (suncg_preprocess.py:341-356)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    out = boxes.copy()
    out[:, 1] = -boxes[:, 2]
    out[:, 2] = boxes[:, 1]
    out[:, 4] = boxes[:, 5]
    out[:, 5] = boxes[:, 4]
    return out


def cam2world_points(points: np.ndarray) -> np.ndarray:
    """(x, y, z) -> (x, -z, y) (suncg_preprocess.py:366-373)."""
    points = np.asarray(points, np.float64)
    out = points.copy()
    out[:, 1] = -points[:, 2]
    out[:, 2] = points[:, 1]
    return out


def parse_obj_parts(obj_text: str) -> List[Dict]:
    """Split a Wavefront OBJ into 'o'-named parts with global-indexed
    vertices resolved per part (suncg_preprocess.read_obj_parts)."""
    vertices: List[List[float]] = []
    parts: List[Dict] = []
    current: Optional[Dict] = None
    for raw in obj_text.splitlines():
        line = raw.strip().split()
        if not line:
            continue
        if line[0] == "o":
            if current and current["vidx"]:
                parts.append(current)
            current = {"name": line[1] if len(line) > 1 else "",
                       "vidx": []}
        elif line[0] == "v":
            vertices.append([float(x) for x in line[1:4]])
        elif line[0] == "f" and current is not None:
            for tok in line[1:]:
                vi = int(tok.split("/")[0])
                current["vidx"].append(
                    vi - 1 if vi > 0 else len(vertices) + vi)
    if current and current["vidx"]:
        parts.append(current)
    varr = np.asarray(vertices, np.float64)
    out = []
    for p in parts:
        vid = sorted(set(p["vidx"]))
        v = varr[vid]
        if np.isnan(v).all():
            continue
        out.append({"name": p["name"], "vertices": v})
    return out


def part_oriented_bbox(vertices: np.ndarray,
                       name: str = "") -> Optional[np.ndarray]:
    """Oriented box of a mesh part in the CAMERA frame (Y up) —
    suncg_preprocess.get_part_bbox semantics:

      * the part's 8 outermost vertices (max distance from centroid)
        define the box; walls are upright rectangles (pitch = roll = 0,
        yaw about Y);
      * parts that are not an oriented rectangle fall back to the
        axis-aligned box when their class allows it (Ceiling/Floor/Room),
        otherwise are rejected (returns None).
    """
    class_name = name.split("#")[0]
    v = np.asarray(vertices, np.float64)
    box_min, box_max = v.min(0), v.max(0)
    centroid = (box_min + box_max) / 2
    y_size = box_max[1] - box_min[1]

    dist = np.linalg.norm(v - centroid, axis=1)
    out_corners = v[np.abs(dist - dist.max()) < 1e-5]
    if out_corners.shape[0] != 8:
        if class_name in NO_RECTANGLE_OK:
            return bbox_from_minmax(box_min, box_max)
        return None

    right = out_corners[out_corners[:, 0] - centroid[0] > 0]
    if right.shape[0] != 4:
        if class_name in NO_RECTANGLE_OK:
            return bbox_from_minmax(box_min, box_max)
        return None
    right_cen = right.mean(0)
    x_size = np.linalg.norm(right_cen - centroid) * 2

    x_dir = (right_cen - centroid) / max(np.linalg.norm(
        right_cen - centroid), 1e-12)
    yaw = np.arccos(np.clip(x_dir[0], -1, 1))
    if abs(yaw) < 0.01:
        yaw = 0.0
    else:
        yaw *= np.sign(x_dir[2])

    top = right[right[:, 1] - centroid[1] > 0]
    if top.shape[0] != 2:
        if class_name in NO_RECTANGLE_OK:
            return bbox_from_minmax(box_min, box_max)
        return None
    z_size = np.linalg.norm(top[0] - top[1])
    return np.array([centroid[0], centroid[1], centroid[2],
                     x_size, y_size, z_size, yaw])


def room_obj_boxes(obj_text: str) -> List[np.ndarray]:
    """Per-part oriented boxes of one room OBJ (camera frame)."""
    boxes = []
    for part in parse_obj_parts(obj_text):
        b = part_oriented_bbox(part["vertices"], part["name"])
        if b is not None:
            boxes.append(b)
    return boxes


def default_room_loader(house_dir: str) -> Callable[[str, str],
                                                    Optional[str]]:
    """Loads <house_dir>/../../room/<house>/<modelId><k>.obj text, k in
    {w, c, f} (suncg_preprocess.split_room_parts path convention)."""

    def load(model_id: str, kind: str) -> Optional[str]:
        room_dir = os.path.join(os.path.dirname(house_dir), "..", "room",
                                os.path.basename(house_dir))
        path = os.path.join(room_dir, f"{model_id}{kind}.obj")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()

    return load


def parse_house(house: Dict,
                room_loader: Optional[Callable] = None,
                model_id_to_class: Optional[Dict[str, str]] = None
                ) -> Dict[str, np.ndarray]:
    """house.json dict -> {category: (N, 7) standard boxes, world frame}.

    Mirrors suncg_preprocess.gen_bbox:550-600: house/level/Object/Room
    node boxes; Room nodes expand to their per-room wall ('w'),
    ceiling ('c') and floor ('f') meshes via ``room_loader(model_id,
    kind) -> obj text`` (the reference reads
    room/<house>/<modelId>{w,c,f}.obj, split_room_parts:652-675).
    """
    assert house.get("scaleToMeters", 1) == 1
    model_id_to_class = model_id_to_class or {}
    kinds = {"w": "wall", "c": "ceiling", "f": "floor"}
    bboxes: Dict[str, List[np.ndarray]] = defaultdict(list)
    bboxes["house"].append(bbox_from_minmax(house["bbox"]["min"],
                                            house["bbox"]["max"]))

    for level in house.get("levels", []):
        if "bbox" not in level:
            continue
        bboxes["level"].append(bbox_from_minmax(level["bbox"]["min"],
                                                level["bbox"]["max"]))
        for node in level.get("nodes", []):
            ntype = node.get("type")
            if ntype == "Object":
                cat = model_id_to_class.get(node.get("modelId"), "object")
                if "bbox" in node:
                    bboxes[cat].append(bbox_from_minmax(
                        node["bbox"]["min"], node["bbox"]["max"]))
            elif ntype == "Room":
                if "bbox" in node:
                    bboxes["room"].append(bbox_from_minmax(
                        node["bbox"]["min"], node["bbox"]["max"]))
                if room_loader is not None:
                    for kind, cat in kinds.items():
                        text = room_loader(node.get("modelId", ""), kind)
                        if text:
                            bboxes[cat].extend(room_obj_boxes(text))
            elif "bbox" in node:
                bboxes[ntype].append(bbox_from_minmax(
                    node["bbox"]["min"], node["bbox"]["max"]))

    out = {}
    for cat, lst in bboxes.items():
        arr = (np.stack(lst) if lst
               else np.zeros((0, 7), np.float64)).reshape(-1, 7)
        out[cat] = cam2world_box(arr).astype(np.float32)
    return out


def refine_house_boxes(bboxes: Dict[str, np.ndarray],
                       level_num: int = 1) -> Dict[str, np.ndarray]:
    """The GT refinement chain of gen_bbox:608-616 (single-level houses):
    wall merge/crop/dedup, window+door alignment to host walls, per-room
    ceiling/floor validation against the refined walls."""
    out = dict(bboxes)
    if level_num != 1:
        return out
    get = lambda k: np.asarray(bboxes.get(k, np.zeros((0, 7))), np.float64)
    out["wall"] = preprocess_walls(get("wall"))
    out["window"] = preprocess_windows(get("window"), out["wall"])
    out["door"] = preprocess_doors(get("door"), out["wall"])
    out["ceiling_raw"] = get("ceiling")
    out["floor_raw"] = get("floor")
    ceiling, floor = get("ceiling"), get("floor")
    if ceiling.shape[0] == 0 and floor.shape[0] == 0:
        # house carries no per-room slab nodes: reconstruct rooms from
        # the refined walls (gt_preprocess.rooms_from_walls) instead of
        # the old single-envelope fallback
        from detection_3d_tpu_torch.data.gt_preprocess import (
            make_ceiling_floor)
        ceiling, floor = make_ceiling_floor(out["wall"])
    out["ceiling"] = preprocess_cfr(ceiling, out["wall"])
    out["floor"] = preprocess_cfr(floor, out["wall"])
    return out


def sample_surface_points(bboxes: Dict[str, np.ndarray],
                          num_points: int = 500_000,
                          categories=("wall", "window", "door", "ceiling",
                                      "floor"),
                          seed: int = 0) -> np.ndarray:
    """Point cloud sampled on the two large faces of every GT box,
    proportional to face area — the geometry-only stand-in for the
    reference's depth-image rendering (gen_pcl, which needs raw SUNCG
    cameras + renderer)."""
    from detection_3d_tpu_torch.data.synthetic import _box_surface_points

    rng = np.random.RandomState(seed)
    boxes = [b for c in categories for b in np.asarray(bboxes.get(c, ()))]
    if not boxes:
        return np.zeros((0, 3), np.float32)
    boxes = np.asarray(boxes, np.float64)
    sizes = boxes[:, 3:6]
    areas = np.max(sizes, 1) * np.median(sizes, 1)
    weights = areas / areas.sum()
    pts = []
    for i, b in enumerate(boxes):
        n = max(int(weights[i] * num_points), 8)
        pts.append(_box_surface_points(rng, b[:3], b[3:6], b[6], n))
    return np.concatenate(pts, 0).astype(np.float32)


def house_point_cloud(bboxes: Dict[str, np.ndarray],
                      num_points: int = 500_000,
                      method: str = "render",
                      seed: int = 0, **render_kw) -> np.ndarray:
    """House GT boxes -> (N, 3) point cloud. ``method="render"`` is the
    reference-parity path (depth images from generated room cameras,
    gen_pcl, suncg_preprocess.py:673-777 — occlusion-correct,
    view-dependent density); ``method="surface"`` the fast area-weighted
    face sampler. Both end capped at ``num_points`` by uniform choice
    (gen_pcl's per-image pre-downsample plays the same role)."""
    if method == "render":
        from detection_3d_tpu_torch.data.depth_render import (
            render_house_pcl)
        pts = render_house_pcl(bboxes, seed=seed, **render_kw)
    elif method == "surface":
        pts = sample_surface_points(bboxes, num_points, seed=seed)
    else:
        raise ValueError(f"unknown point source {method!r}")
    if pts.shape[0] > num_points:
        rng = np.random.RandomState(seed)
        pts = pts[np.sort(rng.choice(pts.shape[0], num_points, False))]
    return pts


def parse_house_file(house_fn: str,
                     model_id_to_class: Optional[Dict] = None,
                     refine: bool = True) -> Dict[str, np.ndarray]:
    """Full offline stage for one house.json on disk."""
    with open(house_fn) as f:
        house = json.load(f)
    loader = default_room_loader(os.path.dirname(house_fn))
    boxes = parse_house(house, loader, model_id_to_class)
    if refine:
        boxes = refine_house_boxes(boxes,
                                   level_num=len(house.get("levels", [])))
    return boxes
