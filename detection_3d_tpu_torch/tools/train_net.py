"""Config-driven train + eval CLI of the PyTorch port.

    python -m detection_3d_tpu_torch.tools.train_net \
        --config-file cfg.yaml [--synthetic N | --data-root DIR] \
        [--only-test] [--skip-test] [--device cuda|cpu] [KEY VALUE ...]
    torchrun --nproc-per-node N -m detection_3d_tpu_torch.tools.train_net \
        [--dist-backend nccl|gloo] ...

Counterpart of the JAX package's tools/train_net.py (reference
tools/train_net_sparse3d.py:139-225): loads a YAML config
(reference-format overlays accepted), copies it into OUTPUT_DIR, trains
for EPOCHS with an evaluation every EPOCHS_BETWEEN_TEST epochs,
supports --only-test / --skip-test, and auto-resumes from the
``last_checkpoint`` tag in OUTPUT_DIR.

Data: reference-format houses under --data-root (default
$SUNCG_TORCH_PATH), or --synthetic N generated buildings. Under
``torchrun`` (WORLD_SIZE > 1) training is data-parallel over the ranks
(parallel/mesh.py; NCCL, one card a rank, unless --dist-backend says
gloo), ``ims_per_batch`` rounded up to a multiple of the ranks as the
JAX CLI does; the test buildings are split over the ranks and their
detections gathered before the evaluation; only rank 0 logs and
writes.
"""

from __future__ import annotations

import argparse
import os
import shutil


def train_and_evaluate(cfg, train_scenes, test_scenes, *, only_test=False,
                       skip_test=False, device="cuda", logger=None,
                       scan_steps=1, mesh=None):
    """The CLI's body after argument parsing: a Trainer on ``device``,
    resumed from ``cfg.output_dir``'s ``last_checkpoint`` tag when there
    is one, then ``max(1, epochs // epochs_between_test)`` rounds of
    training ``epochs_between_test`` epochs (unless ``only_test``) and
    ``run_inference(evaluate=True)`` on ``test_scenes`` (unless
    ``skip_test``); ``only_test`` stops after the first round.

    With a ``mesh`` (parallel/mesh.make_mesh, ``dp`` axis) the Trainer
    is data-parallel and rank r serves the test buildings r, r + n, ...;
    their detections are gathered (parallel/mesh.all_gather_results)
    and every rank evaluates them all.

    Returns (trainer, state, predictions, result): the last evaluation's
    predictions and DetectionEvalResult, or None where none ran."""
    from detection_3d_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, output_dir=cfg.output_dir, logger=logger,
                      device=device, mesh=mesh)
    trainer.scan_steps = scan_steps
    state = trainer.init_state(iters_per_epoch=max(
        -(-len(train_scenes) // trainer.batch_size()), 1))
    saved = trainer.checkpointer.load()
    if saved is not None:
        state.load_state_dict(saved)
    ebt = cfg.solver.epochs_between_test
    rounds = max(1, cfg.solver.epochs // max(ebt, 1))
    preds = result = None
    for _ in range(rounds):
        if not only_test:
            state = trainer.train(train_scenes, state, epochs=ebt)
        if not skip_test:
            preds, result = _evaluate(cfg, state.model, test_scenes,
                                      trainer.device, logger, mesh)
        if only_test:
            break
    return trainer, state, preds, result


def _evaluate(cfg, model, test_scenes, device, logger, mesh):
    """(predictions, DetectionEvalResult) of ``test_scenes``: served on
    this device, or over the mesh's ranks and gathered."""
    from detection_3d_tpu_torch.engine.inference import run_inference
    from detection_3d_tpu_torch.evaluation.detection_eval import (
        eval_aug_thickness, evaluate_detections)
    from detection_3d_tpu_torch.parallel.mesh import all_gather_results

    if mesh is None:
        preds, result, _ = run_inference(cfg, model, test_scenes,
                                         device=device, evaluate=True,
                                         logger=logger)
        return preds, result
    r, n = mesh.rank, mesh.world_size
    local, _, sec = run_inference(cfg, model, test_scenes[r::n],
                                  device=device, logger=logger)
    preds = [None] * len(test_scenes)
    for q, part in enumerate(all_gather_results(local)):
        preds[q::n] = part
    gts = [{"boxes": s["gt_boxes"], "labels": s["gt_labels"]}
           for s in test_scenes]
    result = evaluate_detections(
        preds, gts, cfg.num_classes, cfg.test.iou_threshold,
        eval_aug_thickness=eval_aug_thickness(cfg),
        class_names=cfg.ordered_class_names(), device=device)
    if logger:
        logger.info("\n%s", result.summary())
        logger.info("sec/building: %.3f (rank 0's %d buildings)", sec,
                    len(test_scenes[r::n]))
    return preds, result


def _opts_to_config(cfg, opts):
    """KEY VALUE pairs over the config: dotted field paths
    (``solver.epochs 2``), values as Python literals."""
    import ast
    import dataclasses
    if len(opts) % 2:
        raise SystemExit(f"opts must be KEY VALUE pairs, got {opts}")
    for key, text in zip(opts[::2], opts[1::2]):
        try:
            value = ast.literal_eval(text)
        except (ValueError, SyntaxError):
            value = text
        if isinstance(value, list):
            value = tuple(value)
        *path, name = key.split(".")
        nodes = [cfg]
        for part in path:
            nodes.append(getattr(nodes[-1], part))
        new = dataclasses.replace(nodes[-1], **{name: value})
        for parent, part in zip(nodes[-2::-1], path[::-1]):
            new = dataclasses.replace(parent, **{part: new})
        cfg = new
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train and evaluate the PyTorch port on one card, or "
        "data-parallel under torchrun.")
    ap.add_argument("--config-file", default="", help="YAML config overlay")
    ap.add_argument("--only-test", action="store_true")
    ap.add_argument("--skip-test", action="store_true")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="use N synthetic buildings instead of SUNCG data")
    ap.add_argument("--scan-steps", type=int, default=1,
                    help="train steps per host fetch (K steps back to back, "
                    "gated on the card)")
    ap.add_argument("--data-root", default=os.environ.get(
        "SUNCG_TORCH_PATH", ""))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                    "versions)")
    ap.add_argument("--dist-backend", default="nccl",
                    help="under torchrun: nccl (default, one card a rank) "
                    "or gloo (ranks sharing cards, or on the CPU)")
    ap.add_argument("opts", nargs="*", default=[],
                    help="KEY VALUE config overrides, e.g. solver.epochs 2")
    args = ap.parse_args(argv)

    from detection_3d_tpu_torch.config import Config, load_yaml_config
    from detection_3d_tpu_torch.utils.logger import setup_logger

    cfg = load_yaml_config(args.config_file) if args.config_file else Config()
    cfg = _opts_to_config(cfg, args.opts)
    cfg.validate()

    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from detection_3d_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(axis="dp", backend=args.dist_backend,
                         device=args.device)
    out = cfg.output_dir
    logger = None
    if mesh is None or mesh.is_main:     # only rank 0 logs and writes
        os.makedirs(out, exist_ok=True)
        logger = setup_logger("detection_3d_tpu_torch", out)
        if args.config_file:
            shutil.copyfile(args.config_file, os.path.join(
                out, os.path.basename(args.config_file)))
        logger.info("config: %s", cfg)
    if mesh is not None and logger:
        from detection_3d_tpu_torch.parallel.mesh import dp_batch_size
        logger.info("data-parallel: %d ranks, %d buildings/step",
                    mesh.world_size,
                    dp_batch_size(cfg.solver.ims_per_batch, mesh.world_size))

    if args.synthetic > 0:
        from detection_3d_tpu_torch.data.synthetic import synthetic_building
        train_scenes = [synthetic_building(
            seed=i, classes=cfg.classes,
            voxel_scale=cfg.sparse3d.voxel_scale)
            for i in range(args.synthetic)]
        test_scenes = [synthetic_building(
            seed=1000 + i, classes=cfg.classes,
            voxel_scale=cfg.sparse3d.voxel_scale)
            for i in range(max(1, args.synthetic // 4))]
    else:
        from detection_3d_tpu_torch.data.suncg import SUNCGDataset
        train_ds = SUNCGDataset("train", cfg, args.data_root)
        test_ds = SUNCGDataset("test", cfg, args.data_root)
        if len(train_ds) == 0:
            raise SystemExit("no input data (set SUNCG_TORCH_PATH, "
                             "--data-root or --synthetic)")
        train_scenes = [train_ds[i] for i in range(len(train_ds))]
        test_scenes = [test_ds[i] for i in range(len(test_ds))]

    try:
        train_and_evaluate(cfg, train_scenes, test_scenes,
                           only_test=args.only_test,
                           skip_test=args.skip_test, device=args.device,
                           logger=logger, scan_steps=args.scan_steps,
                           mesh=mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
