"""Overfit synthetic buildings and check that the detector finds their
boxes: the repo's quality gate that a configuration learns.

    python -m detection_3d_tpu_torch.tools.overfit_check [--groups]
        [--scenes N] [--steps 4000] [--chunk 100] [--lr LR] [--fullres]
        [--device cuda|cpu] [--output-dir DIR]

Counterpart of the repo-level tools/overfit_check.py (the reference's
config-driven small-data runs, configs/*_SD.yaml): train until the
model overfits, evaluate on the same buildings, and gate on PER-CLASS
AP (every foreground class with gt above 0.3, and the mean above 0.5),
not on the wall-dominated mean. Exit code 0 when the gate passes, 1
when it fails.

Modes: one 6-class building (6c); ``--scenes N`` buildings (the _SD
multi-scene analogue); ``--groups`` the separate-classifier groups
(("wall",), ("ceiling", "floor")) of configs/3G6c; ``--fullres`` the
reference resolution (2 cm voxels, 9 scales) on multi-room buildings.

Training runs :meth:`Trainer.train_resident` (every building packed once
and kept on the card, ``--chunk`` steps per host fetch) for
ceil(steps / N) epochs: where the JAX tool scans ``--chunk`` steps on one
building at a time, here every epoch visits the N buildings in a fresh
shuffle. Writes ``summary.json`` (per-class AP and AIoU, means, steps,
seconds, the device), the evaluator's result files and the checkpoints
into ``--output-dir`` (default ``detection_3d_tpu_torch/build/
overfit_check``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

CLASSES6 = ("background", "wall", "door", "window", "ceiling", "floor")
GROUPS_3G6C = (("wall",), ("ceiling", "floor"))


def _default_output(name: str) -> str:
    from detection_3d_tpu_torch.ops.cuda_lib import BUILD_DIR
    return str(BUILD_DIR / name)


def overfit_config(groups: bool = False):
    """25 vox/m, 5 scales, class-matched anchors (the reference 6c set's
    shapes: full-height thin walls, door and window sizes, a flat slab
    for ceiling and floor), so each class's best anchor argmaxes itself
    under criterion 2 with the label thickness floors."""
    from detection_3d_tpu_torch.config.defaults import (
        CapacityConfig, Config, ROIConfig, RPNConfig, SolverConfig,
        Sparse3DConfig)
    return Config(
        classes=CLASSES6,
        separate_classes=GROUPS_3G6C if groups else (),
        sparse3d=Sparse3DConfig(
            voxel_scale=25, voxel_full_scale=(512, 512, 128),
            nplanes_front=(16, 32, 32, 64, 64), kernels=((2, 2, 2),) * 4,
            strides=((2, 2, 2),) * 4, nplane_map=32),
        rpn=RPNConfig(
            rpn_scales_from_top=(3, 2, 1),
            # 3 x 3D maps + their 3 BEV copies
            rpn_3d_2d_selector=(0, 1, 2, 3, 4, 5),
            anchor_sizes_3d=((0.4, 1.5, 2.7),    # wall (<= 2.7 m pieces)
                             (0.4, 0.9, 2.0),    # door
                             (0.4, 1.2, 1.0),    # window
                             (0.6, 2.5, 2.7),    # wall (<= 4.5 m pieces)
                             (4.0, 4.0, 0.8),    # ceiling / floor slab
                             (0.2, 0.9, 2.7)),   # short wall stubs
            use_yaws=(1, 1, 1, 1, 0, 1),
            fpn_pre_nms_top_n_train=2048, fpn_pre_nms_top_n_test=2048,
            fpn_post_nms_top_n_train=512, fpn_post_nms_top_n_test=512,
            batch_size_per_image=256),
        roi=ROIConfig(pooler_scales_from_top=(3, 2),
                      batch_size_per_image=256, detections_per_img=64,
                      mlp_head_dim=128),
        backbone_out_channels=32,
        solver=SolverConfig(base_lr=0.01, warmup_epochs=10,
                            lr_step_epochs=(10000,), epochs=1,
                            checkpoint_period_epochs=100000),
        caps=CapacityConfig(max_points=30_000,
                            voxel_caps=(32768, 16384, 8192, 4096, 2048),
                            max_gt=24),
        output_dir=_default_output("overfit_check"),
    ).validate()


def fullres_config():
    """Reference resolution: 2 cm voxels on the full 4096^2 x 512 grid,
    9 scales (the topology of the reference's 6c_Fpn4321 config), with
    the class-matched anchors of :func:`overfit_config`. The JAX tool's
    fullres_config selects all 8 RPN maps for its 6 anchor sizes and
    fails its own validate; here the first 6 maps are selected (the 4
    3D maps and the BEV copies of the two coarsest)."""
    from detection_3d_tpu_torch.config.defaults import (
        CapacityConfig, Config, ROIConfig, RPNConfig, SolverConfig,
        Sparse3DConfig)
    return Config(
        classes=CLASSES6,
        sparse3d=Sparse3DConfig(
            voxel_scale=50, voxel_full_scale=(4096, 4096, 512),
            nplanes_front=(32, 64, 64, 128, 128, 128, 256, 256, 256),
            kernels=((2, 2, 2),) * 8, strides=((2, 2, 2),) * 8,
            nplane_map=32),
        rpn=RPNConfig(
            rpn_scales_from_top=(4, 3, 2, 1),
            rpn_3d_2d_selector=(0, 1, 2, 3, 4, 5),
            anchor_sizes_3d=((0.4, 1.5, 2.7), (0.4, 0.9, 2.0),
                             (0.4, 1.2, 1.0), (0.6, 2.5, 2.7),
                             (4.0, 4.0, 0.8), (0.2, 0.9, 2.7)),
            use_yaws=(1, 1, 1, 1, 0, 1),
            fpn_pre_nms_top_n_train=2048, fpn_pre_nms_top_n_test=2048,
            fpn_post_nms_top_n_train=512, fpn_post_nms_top_n_test=512,
            batch_size_per_image=256),
        roi=ROIConfig(pooler_scales_from_top=(4, 3),
                      batch_size_per_image=256, detections_per_img=100,
                      mlp_head_dim=128),
        backbone_out_channels=32,
        solver=SolverConfig(base_lr=0.01, warmup_epochs=10,
                            lr_step_epochs=(10000,), epochs=1,
                            checkpoint_period_epochs=100000),
        caps=CapacityConfig(
            max_points=250_000,
            voxel_caps=(262144, 131072, 65536, 32768, 16384, 8192, 4096,
                        2048, 1024),
            max_gt=128, dense_grid_max_entries=1 << 28),
        output_dir=_default_output("overfit_fullres"),
    ).validate()


def class_gate(result, cfg, class_min: float = 0.3, report=print):
    """Per-class AP gate: every foreground class with gt must have a
    finite AP above ``class_min`` (nan AP = no detection of that class).
    Prints a line per class through ``report``; returns
    (ok, {class name: AP})."""
    import numpy as np
    names = cfg.ordered_class_names()
    ok, per_class = True, {}
    for lab in range(1, cfg.num_classes):
        if result.n_gt[lab] == 0:
            continue
        ap = float(result.ap[lab])
        ok_l = bool(np.isfinite(ap) and ap > class_min)
        per_class[names[lab]] = ap
        report(f"  class {names[lab]:8s} AP={ap:.3f} "
               f"AIoU={float(result.aiou[lab]):.3f} "
               f"{'ok' if ok_l else 'FAIL'}")
        ok &= ok_l
    return ok, per_class


def write_summary(out_dir: str, summary: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
    return path


def run(args) -> int:
    import torch
    from detection_3d_tpu_torch.data.synthetic import (
        synthetic_building, synthetic_multiroom)
    from detection_3d_tpu_torch.engine.inference import run_inference
    from detection_3d_tpu_torch.engine.trainer import Trainer
    from detection_3d_tpu_torch.evaluation.detection_eval import save_results
    from detection_3d_tpu_torch.utils.device import resolve_device
    from detection_3d_tpu_torch.utils.logger import setup_logger

    dev = resolve_device(args.device)
    cfg = fullres_config() if args.fullres else \
        overfit_config(groups=args.groups)
    if args.lr:
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                     base_lr=args.lr))
    if args.output_dir:
        cfg = cfg.replace(output_dir=args.output_dir)
    logger = setup_logger("overfit", cfg.output_dir)
    vs = cfg.sparse3d.voxel_scale
    if args.fullres:
        # ~24 m 3 x 3-room buildings, 200k points at 2 cm voxels
        scenes = [synthetic_multiroom(seed=i, num_points=200_000,
                                      rooms_xy=(3, 3), room=8.0,
                                      classes=cfg.classes, voxel_scale=vs)
                  for i in range(args.scenes)]
    else:
        scenes = [synthetic_building(seed=i, num_points=25_000, room=6.0,
                                     classes=cfg.classes, voxel_scale=vs)
                  for i in range(args.scenes)]
    logger.info("%d scene(s); scene0: %d points, %d gt boxes; groups %d; "
                "device %s", len(scenes), scenes[0]["points"].shape[0],
                scenes[0]["gt_boxes"].shape[0], cfg.group_num, dev)

    trainer = Trainer(cfg, output_dir=cfg.output_dir, logger=logger,
                      device=dev)
    state = trainer.init_state(seed=0, iters_per_epoch=1)
    epochs = max(1, math.ceil(args.steps / len(scenes)))
    t0 = time.perf_counter()
    state = trainer.train_resident(
        scenes, state, epochs=epochs,
        chunk=min(args.chunk, epochs * len(scenes)))
    train_s = time.perf_counter() - t0
    steps = len(trainer.history)
    logger.info("trained %d steps in %.1fs", steps, train_s)

    eval_scenes = scenes if len(scenes) > 1 else [scenes[0], scenes[0]]
    _, result, spb = run_inference(cfg, state.model, eval_scenes,
                                   device=dev, evaluate=True, logger=logger)
    save_results(result, cfg.output_dir, len(eval_scenes),
                 cfg.test.iou_threshold)
    print("\n" + result.summary())
    print(f"\nmean AP: {result.ap[0]:.4f}  mean AIoU: {result.aiou[0]:.4f}")
    print(f"sec/building: {spb:.3f}")
    per_class_ok, per_class = class_gate(result, cfg)
    ok = bool(per_class_ok and result.ap[0] > 0.5)
    print("OVERFIT CHECK:", "PASS" if ok else "FAIL")
    write_summary(cfg.output_dir, {
        "ok": ok, "per_class_ap": per_class,
        "per_class_aiou": {n: float(result.aiou[l]) for l, n in
                           enumerate(cfg.ordered_class_names())
                           if l and result.n_gt[l]},
        "mean_ap": float(result.ap[0]), "mean_aiou": float(result.aiou[0]),
        "steps": steps, "train_seconds": train_s,
        "non_finite_steps": trainer.resident_skipped,
        "sec_per_building": spb, "groups": cfg.group_num,
        "scenes": len(scenes), "fullres": bool(args.fullres),
        "device": str(dev), "device_name": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")})
    return 0 if ok else 1


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--chunk", type=int, default=100,
                    help="training steps per host fetch (train_resident)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                    "versions)")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--scenes", type=int, default=1,
                    help="number of buildings (the _SD analogue)")
    ap.add_argument("--groups", action="store_true",
                    help="separate-classifier groups (the 3G6c analogue)")
    ap.add_argument("--fullres", action="store_true",
                    help="reference resolution: 2 cm voxels, 9 scales on "
                    "the 4096^2 x 512 grid, multi-room buildings")
    ap.add_argument("--output-dir", default="",
                    help="summary, results and checkpoints (default: the "
                    "config's output_dir under detection_3d_tpu_torch/"
                    "build/)")
    return ap


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
