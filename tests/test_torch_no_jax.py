"""The port stands alone: no module of detection_3d_tpu_torch, and not
chip_smoke.py, imports jax, flax or the JAX package; and its entry points
run on the card unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "detection_3d_tpu_torch"
FORBIDDEN = ("jax", "flax", "detection_3d_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_forbidden_import_statement():
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'detection_3d_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import detection_3d_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "         'detection_3d_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(' '.join(names))\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20     # every module was reached
    # the host input paths, the C++ packer's and loader's wrappers, the
    # scene packs and their converter among them
    for mod in ("data.packing", "data.pyramid_packing", "data.native_packer",
                "engine.inference", "data.scene_pack", "data.native_build",
                "data.native_loader", "tools.convert_scene_packs",
                "engine.trainer", "models.separate_classifier",
                "data.augment", "data.scene_packing", "tools.overfit_check",
                "tools.generalization_check"):
        assert f"detection_3d_tpu_torch.{mod}" in res.stdout.split(), mod


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from detection_3d_tpu_torch.config.defaults import Config
    from detection_3d_tpu_torch.engine.inference import (
        make_batch_predict_fn, make_predict_fn, run_inference,
    )
    from detection_3d_tpu_torch.evaluation.detection_eval import (
        evaluate_detections,
    )
    from detection_3d_tpu_torch.tools.train_net import train_and_evaluate
    from detection_3d_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_predict_fn(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(cfg, None, [])
    # the packed and pipelined serving forms
    for packed in (True, "table", "pyramid"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_predict_fn(cfg, packed=packed)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_batch_predict_fn(cfg, packed=packed)
    for mode in ("pyramid", "table"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_inference(cfg, None, [], pipelined=True, pack_mode=mode)
    # the evaluation after a predict of the caller's own
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(cfg, None, [], evaluate=True, predict_fn=print)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_detections([], [], cfg.num_classes, 0.2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_and_evaluate(cfg.replace(output_dir=str(tmp_path)), [], [])
    # the training entry points: the Trainer whose train, scan, step
    # (raw and packed) and train_resident run on its device
    from detection_3d_tpu_torch.engine.trainer import Trainer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, output_dir=str(tmp_path))
    assert Trainer(cfg, output_dir=str(tmp_path), device="cpu").device == \
        torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    # the quality gates, and the grouped and RPN-only models' predict
    from detection_3d_tpu_torch.tools import (
        generalization_check, overfit_check)
    for tool in (overfit_check, generalization_check):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--output-dir", str(tmp_path / "gate")])
    for kw in ({"separate_classes": (("wall",), ("ceiling", "floor"))},
               {"rpn_only": True}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_predict_fn(cfg.replace(**kw))
