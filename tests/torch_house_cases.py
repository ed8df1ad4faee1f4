"""SUNCG-format houses for the dataset-preparation tests and chip_smoke.py:
numpy only, so the card run can use them without JAX.

A house is what data/house_parser.parse_house_file reads: a
``house/<id>/house.json`` (levels, Room nodes and door and window Object
nodes with axis-aligned boxes) and, per room, the OBJ meshes
``room/<id>/<modelId>{w,c,f}.obj`` of its walls, ceiling and floor, one
``o`` part of 8 corner vertices per box, all in SUNCG's camera frame (Y
up: world (x, y, z) is camera (x, z, -y)).

The layout is that of data/synthetic.synthetic_multiroom: a grid of
``room`` x ``room`` m rooms, each with its 4 walls cut into segments of
at most 2.5 m, a floor and a ceiling slab, a door and a window in its
-y wall.
"""

import json
import os

import numpy as np

WALL_T = 0.095          # synthetic_building's wall thickness
MAX_SEG = 2.5           # and its longest wall segment
MODEL_CLASSES = {"door_m": "door", "window_m": "window"}


def room_boxes(room=8.0, wall_h=2.7):
    """One room centred at the origin, standard world boxes [xc, yc, zc,
    x_size, y_size, z_size, yaw] by kind: "w" walls, "c" ceiling, "f"
    floor, "door", "window" (synthetic_building's boxes at yaw 0)."""
    half = room / 2
    walls = []
    for wx, wy, wyaw in ((0.0, -half, 0.0), (0.0, half, 0.0),
                         (-half, 0.0, np.pi / 2), (half, 0.0, np.pi / 2)):
        n_seg = max(1, int(np.ceil(room / MAX_SEG)))
        seg = room / n_seg
        for si in range(n_seg):
            off = -room / 2 + (si + 0.5) * seg
            cx, cy = (wx + off, wy) if wyaw == 0.0 else (wx, wy + off)
            walls.append([cx, cy, wall_h / 2, seg, WALL_T, wall_h, wyaw])
    return {"w": np.array(walls),
            "f": np.array([[0, 0, 0.06, room, room, 0.12, 0.0]]),
            "c": np.array([[0, 0, wall_h - 0.06, room, room, 0.12, 0.0]]),
            "door": np.array([[-half / 2, -half, 1.0, 0.9, WALL_T * 1.5,
                               2.0, 0.0]]),
            "window": np.array([[half / 2, -half, 1.5, 1.2, WALL_T * 1.5,
                                 1.0, 0.0]])}


def cam_corners(box):
    """The 8 corners (8, 3) of a standard world box in the camera frame:
    centre (x, z, -y), sizes (x, z, y), the yaw about the camera's Y axis
    (local +x to (cos, 0, sin), world (cos, -sin) as the stack's yaw)."""
    cx, cy, cz = box[0], box[2], -box[1]
    xs, ys, zs = box[3], box[5], box[4]
    c, s = np.cos(box[6]), np.sin(box[6])
    out = []
    for dx in (-0.5, 0.5):
        for dy in (-0.5, 0.5):
            for dz in (-0.5, 0.5):
                lx, ly, lz = dx * xs, dy * ys, dz * zs
                out.append([lx * c - lz * s + cx, ly + cy,
                            lx * s + lz * c + cz])
    return np.asarray(out)


def obj_text(named_boxes):
    """A Wavefront OBJ with one ``o`` part per (name, box): its 8 corner
    vertices and two faces over them."""
    lines, base = [], 1
    for name, box in named_boxes:
        lines.append(f"o {name}")
        lines += [f"v {x:.8f} {y:.8f} {z:.8f}" for x, y, z in cam_corners(box)]
        lines.append("f " + " ".join(str(base + i) for i in range(4)))
        lines.append("f " + " ".join(str(base + i) for i in range(4, 8)))
        base += 8
    return "\n".join(lines) + "\n"


def _aabb(box):
    c = cam_corners(box)
    return {"min": c.min(0).tolist(), "max": c.max(0).tolist()}


def write_house(root, house_id="h0", rooms_xy=(5, 5), room=8.0,
                wall_h=2.7):
    """Write one single-level house under ``root`` (``root/house/<id>/
    house.json`` and ``root/room/<id>/r<k>{w,c,f}.obj``). Returns
    (house.json path, the model-id-to-class map to parse it with)."""
    nx, ny = rooms_xy
    house_dir = os.path.join(root, "house", house_id)
    room_dir = os.path.join(root, "room", house_id)
    os.makedirs(house_dir, exist_ok=True)
    os.makedirs(room_dir, exist_ok=True)
    kinds = {"w": "Wall", "c": "Ceiling", "f": "Floor"}
    nodes = []
    for ry in range(ny):
        for rx in range(nx):
            k = ry * nx + rx
            off = np.array([(rx + 0.5) * room, (ry + 0.5) * room, 0.0])
            boxes = room_boxes(room, wall_h)
            for b in boxes.values():
                b[:, :3] += off
            for kind, part in kinds.items():
                with open(os.path.join(room_dir, f"r{k}{kind}.obj"),
                          "w") as f:
                    f.write(obj_text([(f"{part}#{i}", b) for i, b in
                                      enumerate(boxes[kind])]))
            envelope = np.r_[off[:2], wall_h / 2, room, room, wall_h, 0.0]
            nodes.append({"type": "Room", "modelId": f"r{k}",
                          "bbox": _aabb(envelope)})
            for cls in ("door", "window"):
                nodes.append({"type": "Object", "modelId": f"{cls}_m",
                              "bbox": _aabb(boxes[cls][0])})
    whole = np.array([nx * room / 2, ny * room / 2, wall_h / 2, nx * room,
                      ny * room, wall_h, 0.0])
    house = {"id": house_id, "scaleToMeters": 1, "bbox": _aabb(whole),
             "levels": [{"id": "0", "bbox": _aabb(whole), "nodes": nodes}]}
    path = os.path.join(house_dir, "house.json")
    with open(path, "w") as f:
        json.dump(house, f)
    return path, dict(MODEL_CLASSES)
