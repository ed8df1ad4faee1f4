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
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
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
                "tools.generalization_check", "parallel.collectives",
                "parallel.mesh", "parallel.spatial", "parallel.checks",
                "models.factories", "ops.sparse_pool", "data.house_parser",
                "data.gt_preprocess", "data.depth_render", "data.export",
                "utils.flops", "utils.profiling", "utils.viz",
                "tools.bench", "tools.profile_inference",
                "tools.train_bench", "tools.diag_anchor_coverage",
                "tools.clean_models", "tools.visualize_scene"):
        assert f"detection_3d_tpu_torch.{mod}" in res.stdout.split(), mod


@pytest.mark.parametrize("module", ["data.packing", "data.pyramid_packing",
                                    "data.native_packer"])
def test_data_formats_import_no_engine(module):
    """The input formats sit below the engine: importing them loads no
    module of detection_3d_tpu_torch.engine."""
    code = (f"import sys, detection_3d_tpu_torch.{module}\n"
            "print(sorted(m for m in sys.modules\n"
            "      if m.startswith('detection_3d_tpu_torch.engine')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["[]"], res.stdout


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
    # the ranks of a mesh: on the card unless the CPU is asked for (with
    # gloo); NCCL never runs on the CPU
    from detection_3d_tpu_torch.parallel.mesh import rank_device
    for backend in ("nccl", "gloo"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rank_device(backend)
    assert rank_device("gloo", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="gloo"):
        rank_device("nccl", "cpu")
    # the memory statistics read the card's, or nothing for the host
    from detection_3d_tpu_torch.utils.profiling import device_memory_stats
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_memory_stats()
    assert device_memory_stats("cpu") == {}
    # NCCL with fewer cards than ranks raises, never falls back to gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="nccl needs one card per rank"):
        rank_device("nccl")


def test_tools_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """The repo-level tools' twins and the measurements under them run on
    the card by default and raise without one; none falls back to the
    CPU or to a host clock."""
    from detection_3d_tpu_torch.tools import (
        bench, diag_anchor_coverage, profile_inference, train_bench)
    from detection_3d_tpu_torch.utils.device import card_info
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, profile_inference.main, train_bench.main):
        for argv in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                main(argv)
    for argv in (["--small"], ["--parity"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diag_anchor_coverage.main(seeds=(0,), verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diag_anchor_coverage.cli(["--seeds", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        card_info()
    assert card_info("cpu") == {"name": "cpu", "power_limit_w": None,
                                "line": "cpu"}


def test_tensor_entry_points_run_where_their_tensors_are(monkeypatch):
    """plan_levels, the factories, rotate_nms_3d, conv_rulebook and
    deconv_rulebook take the device of the tensors they are given: CPU
    tensors take the plain versions (no kernel launch is counted), and
    nothing reaches for a card that is not there."""
    import numpy as np
    from detection_3d_tpu_torch.models.factories import (
        FullyConvolutionalNet, SparseUNet, SparseVGG, plan_levels)
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.nms import rotate_nms_3d
    from detection_3d_tpu_torch.ops.sparse import (
        build_sparse_tensor, conv_rulebook)
    from detection_3d_tpu_torch.ops.sparse_conv import deconv_rulebook
    from torch_match_cases import random_coords
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coords = torch.from_numpy(random_coords(300, (24, 24, 8), 3))
    t0 = build_sparse_tensor(coords, torch.randn(coords.shape[0], 4), None,
                             (24, 24, 8), 1, 512)
    cuda_lib.reset_launches()
    plan = plan_levels(t0, (512, 256, 128), backward=True)
    for net in (SparseUNet(4, (8, 16, 24)), SparseVGG(4, (("C", 8), ("MP",),
                                                          ("C3/2", 16))),
                FullyConvolutionalNet(4, (8, 16))):
        out = net(plan)
        out = out[0] if isinstance(out, tuple) else out
        out.square().sum().backward()
        assert out.device.type == "cpu"
    t1 = plan["tables"][1]
    assert torch.equal(conv_rulebook(t1, t0, (2, 2, 2), (2, 2, 2)),
                       plan["down"][0].idx)
    assert torch.equal(deconv_rulebook(t0, t1, (2, 2, 2), (2, 2, 2)),
                       plan["up"][0].idx)
    boxes = torch.from_numpy(np.random.RandomState(0).rand(20, 7)
                             .astype(np.float32))
    keep, _ = rotate_nms_3d(boxes, torch.rand(20), torch.ones(20,
                                                             dtype=bool),
                            0.3, 8)
    assert keep.device.type == "cpu"
    assert not any(cuda_lib.launches.values())
