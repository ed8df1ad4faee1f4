"""The port's train-and-evaluate entry point
(detection_3d_tpu_torch/tools/train_net.py) at the tiny config on the CPU:
the CLI as a subprocess (a YAML file written here, ``--synthetic 2``,
``--device cpu``, one epoch), then again with ``--only-test``, which
must resume from the tag; and ``train_and_evaluate`` in this process,
whose resumed parameters and detections must equal the first run's.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from detection_3d_tpu_torch.config import defaults as tdefaults
from detection_3d_tpu_torch.config import load_yaml_config
from detection_3d_tpu_torch.tools.train_net import (
    _opts_to_config, train_and_evaluate)
from test_torch_common import tiny_cfg, tiny_scene

ROOT = Path(__file__).resolve().parent.parent

# the tiny config's mapped keys (tests/test_torch_common.tiny_cfg)
TINY_YAML = """
INPUT:
  CLASSES: ['background', 'wall', 'door', 'window']
SPARSE3D:
  VOXEL_SCALE: 20
  VOXEL_FULL_SCALE: [256, 256, 64]
  nPlanesFront: [8, 16, 16, 32, 32]
  KERNEL: [[2, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2]]
  STRIDE: [[2, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2]]
  nPlaneMap: 16
MODEL:
  BACKBONE:
    OUT_CHANNELS: 16
  RPN:
    RPN_SCALES_FROM_TOP: [2, 1]
    RPN_3D_2D_SELECTOR: [0, 1, 2]
    ANCHOR_SIZES_3D: [[0.2, 0.5, 3], [0.4, 1.5, 3], [0.6, 2.5, 3]]
    USE_YAWS: [1, 1, 1]
    FPN_PRE_NMS_TOP_N_TRAIN: 256
    FPN_PRE_NMS_TOP_N_TEST: 256
    FPN_POST_NMS_TOP_N_TRAIN: 64
    FPN_POST_NMS_TOP_N_TEST: 64
    BATCH_SIZE_PER_IMAGE: 64
  ROI_HEADS:
    BATCH_SIZE_PER_IMAGE: 64
    DETECTIONS_PER_IMG: 32
  ROI_BOX_HEAD:
    POOLER_SCALES_FROM_TOP: [2, 1]
    POOLER_RESOLUTION: (6,8,4)
    MLP_HEAD_DIM: 32
SOLVER:
  EPOCHS: 1
  EPOCHS_BETWEEN_TEST: 1
  CHECKPOINT_PERIOD_EPOCHS: 1
OUTPUT_DIR: "{out}"
"""
# what a YAML file cannot set
TINY_OPTS = ["compute_dtype", "float32", "caps.max_points", "8192",
             "caps.voxel_caps", "(4096,2048,1024,512,256)",
             "caps.max_gt", "16"]


def _write_yaml(tmp_path):
    out = tmp_path / "out"
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML.format(out=out))
    return path, out


def test_yaml_and_opts_give_the_tiny_config(tmp_path):
    path, out = _write_yaml(tmp_path)
    got = _opts_to_config(load_yaml_config(str(path)), TINY_OPTS)
    base = tiny_cfg(tdefaults)
    want = base.replace(
        output_dir=str(out),
        solver=dataclasses.replace(base.solver, epochs=1,
                                   epochs_between_test=1,
                                   checkpoint_period_epochs=1))
    assert got == want


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "detection_3d_tpu_torch.tools.train_net",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def test_cli_trains_evaluates_and_resumes(tmp_path):
    path, out = _write_yaml(tmp_path)
    args = ["--config-file", str(path), "--synthetic", "2", "--device",
            "cpu", *TINY_OPTS]
    _cli(*args)
    files = set(os.listdir(out))
    assert {"log.txt", "tiny.yaml", "model_final.pt",
            "last_checkpoint"} <= files
    assert (out / "tiny.yaml").read_text() == path.read_text()
    log = (out / "log.txt").read_text()
    assert "No checkpoint found; starting fresh" in log
    assert log.count("class      AP      AIoU") == 1
    assert "sec/building" in log and "iter 0 epoch 0" in log
    final = (out / "model_final.pt").stat().st_mtime_ns

    stdout = _cli(*args[:-len(TINY_OPTS)], "--only-test", *TINY_OPTS)
    log = (out / "log.txt").read_text()
    assert "Loaded checkpoint from" in log
    assert log.count("class      AP      AIoU") == 2
    assert log.count("iter 0 epoch 0") == 1        # no training the 2nd time
    assert (out / "model_final.pt").stat().st_mtime_ns == final
    assert "class      AP      AIoU" in stdout


def test_train_and_evaluate_resumes_bit_for_bit(tmp_path):
    cfg = tiny_cfg(tdefaults, output_dir=str(tmp_path))
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, epochs=1, epochs_between_test=1))
    train, test = [tiny_scene(0)], [tiny_scene(1)]
    trainer, state, preds, result = train_and_evaluate(
        cfg, train, test, device="cpu")
    assert state.step == 1 and len(trainer.history) == 1
    want_gt = np.bincount(test[0]["gt_labels"], minlength=cfg.num_classes)
    want_gt[0] = 0
    np.testing.assert_array_equal(result.n_gt, want_gt)
    params = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}

    _, state2, preds2, result2 = train_and_evaluate(
        cfg, train, test, only_test=True, device="cpu")
    assert state2.step == 1 and state2.solver.count == state.solver.count
    for n, p in state2.model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    assert len(preds2) == len(preds)
    for a, b in zip(preds, preds2):
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(b[k], a[k])
    np.testing.assert_array_equal(result2.ap, result.ap)

    _, _, none_preds, none_result = train_and_evaluate(
        cfg, train, test, only_test=True, skip_test=True, device="cpu")
    assert none_preds is None and none_result is None


# the tiny config with the 3G6c groups and class-matched anchors
# (tests/test_torch_separate_classifier.sep_cfg)
TINY_3G6C_YAML = TINY_YAML.replace(
    "CLASSES: ['background', 'wall', 'door', 'window']",
    "CLASSES: ['background', 'wall', 'door', 'window', 'ceiling', "
    "'floor']").replace(
    "MODEL:\n",
    "MODEL:\n  SEPARATE_CLASSES: [['wall'], ['ceiling', 'floor']]\n").replace(
    "ANCHOR_SIZES_3D: [[0.2, 0.5, 3], [0.4, 1.5, 3], [0.6, 2.5, 3]]",
    "ANCHOR_SIZES_3D: [[6.0, 6.0, 0.8], [0.4, 1.5, 3], [0.2, 0.5, 3]]")


def test_cli_trains_evaluates_and_resumes_a_3g6c_yaml(tmp_path):
    from test_torch_separate_classifier import sep_cfg
    out = tmp_path / "out"
    path = tmp_path / "tiny_3g6c.yaml"
    path.write_text(TINY_3G6C_YAML.format(out=out))
    cfg = _opts_to_config(load_yaml_config(str(path)), TINY_OPTS)
    assert cfg == sep_cfg(tdefaults).replace(
        output_dir=str(out), solver=cfg.solver)
    assert cfg.group_num == 3
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "detection_3d_tpu_torch.tools.train_net",
            "--config-file", str(path), "--synthetic", "2", "--device",
            "cpu", *TINY_OPTS]
    for extra in ([], ["--only-test"]):
        res = subprocess.run(args + extra, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-4000:]
    log = (out / "log.txt").read_text()
    for gi in range(3):
        for name in ("loss_objectness", "loss_rpn_box_reg",
                     "loss_classifier_roi", "loss_box_reg_roi"):
            assert f"{name}_{gi}:" in log, (name, gi)
    assert "loss_objectness:" not in log
    assert log.count("iter 0 epoch 0") == 1
    assert "Loaded checkpoint from" in log
    assert log.count("class      AP      AIoU") == 2
    for name in ("ceiling", "floor", "wall"):
        assert f"\n{name} " in log
    state = torch.load(out / "model_final.pt", weights_only=False)
    a = cfg.rpn.num_anchors_per_location
    assert state["model"]["rpn.head.cls_w"].shape[1] == 3 * a
