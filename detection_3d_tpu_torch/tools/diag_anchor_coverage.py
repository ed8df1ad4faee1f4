"""How many gt boxes the RPN's targets cover, by class, on varied buildings.

    python -m detection_3d_tpu_torch.tools.diag_anchor_coverage
        [--seeds 0 1 2 3] [--device cuda|cpu]

Counterpart of the repo-level tools/diag_anchor_coverage.py. It replays
the anchor generation and the criterion-2 matching of a training step
(models/rpn.rpn_targets) at tools/generalization_check.gen_config() over
synthetic_varied_building draws, and reports per class how many gt boxes
get at least one positive anchor above ``fg_iou_threshold`` ("covered"),
how many only a low-quality rescue anchor ("rescued") and how many none
("orphan"), with percentiles of each box's best yaw-gated quality. A
class whose best quality caps below the threshold trains on rescue
anchors only.

The steps: the anchors over the selected RPN maps; rpn_targets' matches;
the criterion-2 quality through boxes_iou_3d (kernel C on the card); the
yaw gate. Runs on the card (the JAX tool forces the CPU); ``--device
cpu`` runs the plain kernels on the CPU. Without a card the default
raises.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch


def scene_coverage(cfg, scene, device="cuda"):
    """Each valid gt box of one building: a list of {class, best (its
    best yaw-gated quality), above (anchors at or above
    fg_iou_threshold), assigned (anchors rpn_targets matched to it)},
    and {gyaw (the last box's yaw), n_gt, anchors_valid, anchors}."""
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, pad_scene)
    from detection_3d_tpu_torch.models.anchors import generate_anchors
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.models.rpn import (
        PARK_QUERIES, PARK_TARGETS, rpn_targets)
    from detection_3d_tpu_torch.ops.geometry import limit_period
    from detection_3d_tpu_torch.ops.rotated_iou import (
        boxes_iou_3d, park_invalid)
    from detection_3d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    names = cfg.ordered_class_names()
    n_scales = cfg.sparse3d.num_scales
    b = pad_scene(cfg, scene)
    with torch.inference_mode():
        (pts, fts, valid), gt, _ = batch_to_device(b, dev)
        pyr = build_pyramid(voxelize_points(cfg, pts, fts, valid), cfg)
        rpn_3d = [pyr["tables"][n_scales - 1 - i]
                  for i in cfg.rpn.rpn_scales_from_top]
        rpn_2d = [pyr["bev"][slot][0] for slot in range(len(rpn_3d))]
        all_maps = rpn_3d + rpn_2d
        anchors = generate_anchors(
            cfg, [all_maps[i] for i in cfg.rpn.rpn_3d_2d_selector])
        _, _, matches = rpn_targets(cfg, anchors, gt)
        aug = {"target_Y": cfg.rpn.label_aug_thickness_y_tar_anc[0],
               "anchor_Y": cfg.rpn.label_aug_thickness_y_tar_anc[1],
               "target_Z": cfg.rpn.label_aug_thickness_z_tar_anc[0],
               "anchor_Z": cfg.rpn.label_aug_thickness_z_tar_anc[1]}
        # pad rows parked apart, as rpn_targets does: the valid pairs'
        # quality is the same, and the IoU computes only boxes that meet
        quality = boxes_iou_3d(
            park_invalid(gt.boxes, gt.valid, PARK_TARGETS),
            park_invalid(anchors.boxes, anchors.valid, PARK_QUERIES),
            aug_thickness=aug, criterion=2).cpu().numpy()
        ydif = limit_period(gt.boxes[:, 6][:, None]
                            - anchors.boxes[:, 6][None, :],
                            0.5, math.pi).cpu().numpy()
        av = anchors.valid.cpu().numpy()
        m = matches.cpu().numpy()
    quality = np.where(av[None, :], quality, -1.0)
    q_gated = np.where(np.abs(ydif) <= cfg.rpn.yaw_threshold, quality, -1.0)
    gl, gv = b["gt_labels"], b["gt_valid"]
    rows = [{"class": names[int(gl[g])], "best": float(q_gated[g].max()),
             "above": int((q_gated[g] >= cfg.rpn.fg_iou_threshold).sum()),
             "assigned": int((m == g).sum())}
            for g in range(len(gv)) if gv[g]]
    return rows, {"gyaw": float(scene["gt_boxes"][-1, 6]),
                  "n_gt": int(gv.sum()), "anchors_valid": int(av.sum()),
                  "anchors": int(av.shape[0])}


def coverage(cfg, scenes, device="cuda", verbose=False):
    """Per class (every class but the background): {n_gt, covered,
    rescued, best (list of each box's best quality)} over ``scenes``, as
    the JAX tool's main returns it."""
    names = cfg.ordered_class_names()
    per_class = {n: {"n_gt": 0, "covered": 0, "rescued": 0, "best": []}
                 for n in names[1:]}
    for i, scene in enumerate(scenes):
        rows, info = scene_coverage(cfg, scene, device)
        if verbose:
            print(f"\nscene {i}: gyaw~{np.degrees(info['gyaw']):.0f}deg "
                  f"{info['n_gt']} gt, anchors "
                  f"{info['anchors_valid']}/{info['anchors']}")
        for r in rows:
            st = per_class[r["class"]]
            st["n_gt"] += 1
            st["best"].append(r["best"])
            if r["above"] > 0:
                st["covered"] += 1
            elif r["assigned"] > 0:
                st["rescued"] += 1
    return per_class


def print_table(cfg, per_class):
    print(f"\nfg_iou_threshold={cfg.rpn.fg_iou_threshold} "
          f"yaw_threshold={cfg.rpn.yaw_threshold:.3f}")
    print(f"{'class':9s} {'n_gt':>5s} {'covered':>8s} {'rescued':>8s} "
          f"{'orphan':>7s} {'best_q: p10':>11s} {'p50':>6s} {'p90':>6s}")
    for cname, st in per_class.items():
        if st["n_gt"] == 0:
            continue
        best = np.array(st["best"])
        orphan = st["n_gt"] - st["covered"] - st["rescued"]
        print(f"{cname:9s} {st['n_gt']:5d} {st['covered']:8d} "
              f"{st['rescued']:8d} {orphan:7d} "
              f"{np.percentile(best, 10):11.3f} "
              f"{np.percentile(best, 50):6.3f} "
              f"{np.percentile(best, 90):6.3f}")


def main(seeds=(0, 1, 2, 3), verbose=True, device="cuda"):
    """:func:`coverage` at gen_config() over synthetic_varied_building
    draws of ``seeds`` (35k points), with the table printed; returns the
    per-class dict."""
    from detection_3d_tpu_torch.data.synthetic import (
        synthetic_varied_building)
    from detection_3d_tpu_torch.tools.generalization_check import gen_config
    from detection_3d_tpu_torch.utils.device import card_info, resolve_device
    card = card_info(resolve_device(device))
    cfg = gen_config()
    scenes = [synthetic_varied_building(
        seed=seed, num_points=35_000, classes=cfg.classes,
        voxel_scale=cfg.sparse3d.voxel_scale) for seed in seeds]
    per_class = coverage(cfg, scenes, device, verbose)
    if verbose:
        print(f"card: {card['line']}")
        print_table(cfg, per_class)
    return per_class


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    main(tuple(args.seeds), True, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
