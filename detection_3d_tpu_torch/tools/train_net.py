"""Config-driven train + eval CLI of the PyTorch port, on one card.

    python -m detection_3d_tpu_torch.tools.train_net \
        --config-file cfg.yaml [--synthetic N | --data-root DIR] \
        [--only-test] [--skip-test] [--device cuda|cpu] [KEY VALUE ...]

Counterpart of the JAX package's tools/train_net.py (reference
tools/train_net_sparse3d.py:139-225): loads a YAML config
(reference-format overlays accepted), copies it into OUTPUT_DIR, trains
for EPOCHS with an evaluation every EPOCHS_BETWEEN_TEST epochs,
supports --only-test / --skip-test, and auto-resumes from the
``last_checkpoint`` tag in OUTPUT_DIR.

Data: reference-format houses under --data-root (default
$SUNCG_TORCH_PATH), or --synthetic N generated buildings. One card:
the JAX CLI's data-parallel mesh is not ported.
"""

from __future__ import annotations

import argparse
import os
import shutil


def train_and_evaluate(cfg, train_scenes, test_scenes, *, only_test=False,
                       skip_test=False, device="cuda", logger=None,
                       scan_steps=1):
    """The CLI's body after argument parsing: a Trainer on ``device``,
    resumed from ``cfg.output_dir``'s ``last_checkpoint`` tag when there
    is one, then ``max(1, epochs // epochs_between_test)`` rounds of
    training ``epochs_between_test`` epochs (unless ``only_test``) and
    ``run_inference(evaluate=True)`` on ``test_scenes`` (unless
    ``skip_test``); ``only_test`` stops after the first round.

    Returns (trainer, state, predictions, result): the last evaluation's
    predictions and DetectionEvalResult, or None where none ran."""
    from detection_3d_tpu_torch.engine.inference import run_inference
    from detection_3d_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, output_dir=cfg.output_dir, logger=logger,
                      device=device)
    trainer.scan_steps = scan_steps
    state = trainer.init_state(iters_per_epoch=max(len(train_scenes), 1))
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
            preds, result, _ = run_inference(cfg, state.model, test_scenes,
                                             device=device, evaluate=True,
                                             logger=logger)
        if only_test:
            break
    return trainer, state, preds, result


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
        description="Train and evaluate the PyTorch port on one card "
        "(multi-device training is not ported).")
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
    ap.add_argument("opts", nargs="*", default=[],
                    help="KEY VALUE config overrides, e.g. solver.epochs 2")
    args = ap.parse_args(argv)

    from detection_3d_tpu_torch.config import Config, load_yaml_config
    from detection_3d_tpu_torch.utils.logger import setup_logger

    cfg = load_yaml_config(args.config_file) if args.config_file else Config()
    cfg = _opts_to_config(cfg, args.opts)
    cfg.validate()

    out = cfg.output_dir
    os.makedirs(out, exist_ok=True)
    logger = setup_logger("detection_3d_tpu_torch", out)
    if args.config_file:
        shutil.copyfile(args.config_file,
                        os.path.join(out, os.path.basename(args.config_file)))
    logger.info("config: %s", cfg)

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

    train_and_evaluate(cfg, train_scenes, test_scenes,
                       only_test=args.only_test, skip_test=args.skip_test,
                       device=args.device, logger=logger,
                       scan_steps=args.scan_steps)


if __name__ == "__main__":
    main()
