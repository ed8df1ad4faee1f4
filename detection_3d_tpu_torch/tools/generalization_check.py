"""Train on many varied synthetic buildings, evaluate on HELD-OUT ones.

    python -m detection_3d_tpu_torch.tools.generalization_check
        [--train-scenes 50] [--test-scenes 15] [--epochs 240] [--gate 0.7]
        [--scan-steps 10 | --resident [--chunk 100]] [--wide]
        [--eval-train 10] [--resume | --resume-train] [--device cuda|cpu]
        [--output-dir DIR]

Counterpart of the repo-level tools/generalization_check.py. The
reference's quality numbers are test-split results over unseen buildings
(reference README.md:19-24, suncg_eval.py:714-965); the overfit gate
(tools/overfit_check.py) checks the machinery, this one generalization:
train on ``--train-scenes`` randomized multi-room buildings
(data/synthetic.synthetic_varied_building: floor plans, sizes, yaw,
openings and density vary), evaluate per-class AP and AIoU on
``--test-scenes`` buildings from disjoint seeds, and gate on every
class's AP above 0.3 and the held-out mean AP at or above ``--gate``.
Exit code 0 when the gate passes, 1 when it fails.

Training is ``Trainer.train`` with ``--scan-steps`` steps per host
fetch, or ``--resident`` (``Trainer.train_resident``, ``--chunk`` steps
a fetch); ``--resume`` evaluates the newest checkpoint of the output
directory, ``--resume-train`` continues a resident run from it. Writes ``summary.json``, the
evaluator's result files and the checkpoints into ``--output-dir``
(default ``detection_3d_tpu_torch/build/generalization_check``).
"""

from __future__ import annotations

import argparse
import sys
import time

from detection_3d_tpu_torch.tools.overfit_check import (
    CLASSES6, _default_output, class_gate, write_summary)


def gen_config(epochs: int = 60, base_lr: float = 0.01, wide: bool = False):
    """The JAX tool's gen_config: 25 vox/m, 5 scales on a 1024^2 x 128
    grid, one anchor type per RPN map (the selector a permutation: the
    head's weights are shared across maps, so two anchor types on one
    map would get the same logits with conflicting targets), slabs on a
    3D map whose sites carry real z. ``wide`` scales the widths toward
    the reference 6c set (32..128 planes, 128 out channels)."""
    from detection_3d_tpu_torch.config.defaults import (
        CapacityConfig, Config, ROIConfig, RPNConfig, SolverConfig,
        Sparse3DConfig)
    return Config(
        classes=CLASSES6,
        sparse3d=Sparse3DConfig(
            voxel_scale=25, voxel_full_scale=(1024, 1024, 128),
            nplanes_front=((32, 64, 64, 128, 128) if wide
                           else (16, 32, 32, 64, 64)),
            kernels=((2, 2, 2),) * 4, strides=((2, 2, 2),) * 4,
            nplane_map=64 if wide else 32),
        rpn=RPNConfig(
            rpn_scales_from_top=(3, 2, 1),
            # maps 0..2 = the 3D scales (8/16/32 cm), 3..5 their BEV copies
            rpn_3d_2d_selector=(1, 3, 0, 4, 2, 5),
            anchor_sizes_3d=((0.4, 1.5, 2.7),    # wall pieces
                             (0.4, 0.9, 2.0),    # door
                             (0.4, 1.2, 1.0),    # window
                             (0.6, 2.5, 2.7),    # long wall pieces
                             (4.5, 4.5, 0.8),    # ceiling / floor slab
                             (0.2, 0.9, 2.7)),   # short wall stubs
            use_yaws=(1, 1, 1, 1, 0, 1),
            fpn_pre_nms_top_n_train=2048, fpn_pre_nms_top_n_test=2048,
            fpn_post_nms_top_n_train=512, fpn_post_nms_top_n_test=512,
            batch_size_per_image=256),
        roi=ROIConfig(pooler_scales_from_top=(3, 2),
                      batch_size_per_image=256, detections_per_img=100,
                      mlp_head_dim=256 if wide else 128),
        backbone_out_channels=128 if wide else 32,
        # decay late (75 % and 92 % of the run)
        solver=SolverConfig(base_lr=base_lr, warmup_epochs=2,
                            lr_step_epochs=(int(epochs * 0.75),
                                            int(epochs * 0.92)),
                            epochs=1, checkpoint_period_epochs=100000),
        caps=CapacityConfig(max_points=45_000,
                            voxel_caps=(65536, 32768, 16384, 8192, 4096),
                            max_gt=128, dense_grid_max_entries=1 << 26),
        output_dir=_default_output("generalization_check"),
    ).validate()


def run(args) -> int:
    import torch
    from detection_3d_tpu_torch.data.synthetic import (
        synthetic_varied_building)
    from detection_3d_tpu_torch.engine.inference import run_inference
    from detection_3d_tpu_torch.engine.trainer import Trainer
    from detection_3d_tpu_torch.evaluation.detection_eval import save_results
    from detection_3d_tpu_torch.utils.device import resolve_device
    from detection_3d_tpu_torch.utils.logger import setup_logger

    dev = resolve_device(args.device)
    cfg = gen_config(epochs=args.epochs, base_lr=args.lr, wide=args.wide)
    if args.output_dir:
        cfg = cfg.replace(output_dir=args.output_dir)
    logger = setup_logger("generalization", cfg.output_dir)

    def make(seed):
        return synthetic_varied_building(
            seed=seed, num_points=35_000, classes=cfg.classes,
            voxel_scale=cfg.sparse3d.voxel_scale)

    # disjoint seed ranges: train [0, N), held-out [10000, 10000 + M)
    t0 = time.perf_counter()
    train_scenes = [make(i) for i in range(args.train_scenes)]
    test_scenes = [make(10_000 + i) for i in range(args.test_scenes)]
    logger.info("generated %d train + %d held-out scenes in %.0fs",
                len(train_scenes), len(test_scenes),
                time.perf_counter() - t0)

    trainer = Trainer(cfg, output_dir=cfg.output_dir, logger=logger,
                      device=dev)
    trainer.scan_steps = args.scan_steps
    state = trainer.init_state(seed=0, iters_per_epoch=len(train_scenes))
    if args.resume or args.resume_train:
        saved = trainer.checkpointer.load()
        if saved is not None:
            state.load_state_dict(saved)
            logger.info("resumed at step %d", state.step)
    t0 = time.perf_counter()
    if args.resume:
        pass    # evaluate only
    elif args.resident or args.resume_train:
        state = trainer.train_resident(train_scenes, state,
                                       epochs=args.epochs, chunk=args.chunk)
    else:
        state = trainer.train(train_scenes, state, epochs=args.epochs)
    train_s = time.perf_counter() - t0

    summary = {}
    if args.eval_train > 0:
        k = min(args.eval_train, len(train_scenes))
        logger.info("evaluating %d TRAIN scenes (gap diagnostic)", k)
        _, tr_result, _ = run_inference(cfg, state.model, train_scenes[:k],
                                        device=dev, evaluate=True)
        print("\nTRAIN-SPLIT " + tr_result.summary())
        summary["train_split_mean_ap"] = float(tr_result.ap[0])

    logger.info("evaluating %d HELD-OUT scenes", len(test_scenes))
    _, result, spb = run_inference(cfg, state.model, test_scenes,
                                   device=dev, evaluate=True)
    save_results(result, cfg.output_dir, len(test_scenes),
                 cfg.test.iou_threshold, epoch=args.epochs)
    print("\nHELD-OUT " + result.summary())
    print(f"\nmean AP: {result.ap[0]:.4f}  mean AIoU: {result.aiou[0]:.4f}"
          f"  sec/building: {spb:.3f}")
    per_class_ok, per_class = class_gate(result, cfg)
    ok = bool(per_class_ok and result.ap[0] >= args.gate)
    print(f"GENERALIZATION CHECK (gate mean AP >= {args.gate}):",
          "PASS" if ok else "FAIL")
    summary.update({
        "ok": ok, "gate": args.gate, "per_class_ap": per_class,
        "mean_ap": float(result.ap[0]), "mean_aiou": float(result.aiou[0]),
        "steps": state.step, "train_seconds": train_s,
        "sec_per_building": spb, "groups": cfg.group_num,
        "train_scenes": len(train_scenes), "test_scenes": len(test_scenes),
        "device": str(dev), "device_name": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")})
    write_summary(cfg.output_dir, summary)
    return 0 if ok else 1


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-scenes", type=int, default=50)
    ap.add_argument("--test-scenes", type=int, default=15)
    ap.add_argument("--epochs", type=int, default=240)
    ap.add_argument("--gate", type=float, default=0.7)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--scan-steps", type=int, default=10,
                    help="training steps per host fetch (Trainer.train)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                    "versions)")
    ap.add_argument("--wide", action="store_true",
                    help="reference-like widths (planes 32..128, 128 out "
                    "channels)")
    ap.add_argument("--resident", action="store_true",
                    help="device-resident training (Trainer.train_resident)")
    ap.add_argument("--resume", action="store_true",
                    help="skip training, evaluate the saved checkpoint")
    ap.add_argument("--resume-train", action="store_true",
                    help="load the newest checkpoint and continue resident "
                    "training from its step")
    ap.add_argument("--chunk", type=int, default=100,
                    help="steps per host fetch on the resident path")
    ap.add_argument("--eval-train", type=int, default=10, metavar="K",
                    help="also evaluate the first K TRAIN scenes (the "
                    "train / held-out gap separates undertraining from "
                    "overfitting)")
    ap.add_argument("--output-dir", default="",
                    help="summary, results and checkpoints (default: the "
                    "config's output_dir under detection_3d_tpu_torch/"
                    "build/)")
    return ap


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
