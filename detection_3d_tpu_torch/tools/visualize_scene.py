"""Render BEV and 3D PNG panels of a scene (synthetic or a scene pack).

    python -m detection_3d_tpu_torch.tools.visualize_scene --seed 3 --out DIR
    python -m detection_3d_tpu_torch.tools.visualize_scene --pack scene.spk \
        --out DIR

Counterpart of the repo-level tools/visualize_scene.py, the headless
stand-in for the reference's open3d debug windows (utils3d/
bbox3d_ops.py draw_*): writes ``bev.png`` and ``scene3d.png`` of the
scene's points and gt boxes with the port's utils/viz.py. ``--pack``
draws one scene pack (data/scene_pack.read_scene_pack: one building a
file); otherwise a synthetic_varied_building draw of ``--seed``. The
scene's points are voxel-scaled and min-shifted, its gt yx_zb boxes in
metres in the same frame, so the points are divided by the scene's
``voxel_scale`` (``--voxel-scale`` where it has none). matplotlib is
imported by the drawing calls only. Needs no device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

CLASSES = ("background", "wall", "door", "window", "ceiling", "floor")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="synthetic_varied_building seed")
    ap.add_argument("--pack", type=str, default=None,
                    help="scene pack (.spk) to draw instead of synthetic")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--num-points", type=int, default=35_000)
    ap.add_argument("--voxel-scale", type=float, default=25.0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    from detection_3d_tpu_torch.ops.geometry import yx_zb_to_standard
    from detection_3d_tpu_torch.utils.viz import (
        draw_points_bboxes, draw_scene_3d)
    if args.pack:
        from detection_3d_tpu_torch.data.scene_pack import read_scene_pack
        scene = read_scene_pack(args.pack)
        title = f"scene pack {os.path.basename(args.pack)}"
    else:
        from detection_3d_tpu_torch.data.synthetic import (
            synthetic_varied_building)
        scene = synthetic_varied_building(seed=args.seed,
                                          num_points=args.num_points,
                                          classes=CLASSES)
        title = f"scene seed={args.seed}"
    vs = float(scene.get("voxel_scale", args.voxel_scale) or 1.0)
    pts = np.asarray(scene["points"]) / vs
    gt = yx_zb_to_standard(torch.from_numpy(np.asarray(
        scene["gt_boxes"], np.float32))).numpy()
    labels = np.asarray(scene["gt_labels"], int)
    bev = draw_points_bboxes(pts, gt, labels,
                             path=os.path.join(args.out, "bev.png"),
                             class_names=CLASSES, title=title)
    three = draw_scene_3d(pts, gt, labels,
                          path=os.path.join(args.out, "scene3d.png"))
    print(f"wrote {bev}\nwrote {three}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
