"""The port's twin of tools/visualize_scene.py
(detection_3d_tpu_torch/tools/visualize_scene.py) on the CPU: it writes
bev.png and scene3d.png for a synthetic building and for a scene pack
written with write_scene_pack. The JAX tool's ``--pack`` branch imports
``load_scene_pack``, which detection_3d_tpu/data/scene_pack.py does not
have (tools/visualize_scene.py:43-44), so it raises ImportError; the
port reads the pack with read_scene_pack (ROADMAP Queue 3)."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from detection_3d_tpu_torch.data.scene_pack import write_scene_pack
from detection_3d_tpu_torch.data.synthetic import synthetic_varied_building
from detection_3d_tpu_torch.tools import visualize_scene

ROOT = Path(__file__).resolve().parent.parent


def _pngs(out: Path):
    for name in ("bev.png", "scene3d.png"):
        data = (out / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000, name


def _pack(path: Path) -> Path:
    scene = synthetic_varied_building(seed=2, num_points=3000)
    write_scene_pack(str(path), {k: v for k, v in scene.items()
                                 if isinstance(v, np.ndarray)})
    return path


def test_draws_a_synthetic_scene_and_a_pack(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = tmp_path / "syn"
    assert visualize_scene.main(["--seed", "1", "--num-points", "3000",
                                 "--out", str(out)]) == 0
    _pngs(out)
    pack = _pack(tmp_path / "scene.spk")
    out = tmp_path / "pack"
    assert visualize_scene.main(["--pack", str(pack), "--out", str(out)]) == 0
    _pngs(out)
    assert capsys.readouterr().out.count("wrote ") == 4


def test_the_jax_tool_cannot_read_a_pack(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    spec = importlib.util.spec_from_file_location(
        "jax_visualize_scene", ROOT / "tools" / "visualize_scene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pack = _pack(tmp_path / "scene.spk")
    monkeypatch.setattr(sys, "argv", ["visualize_scene.py", "--pack",
                                      str(pack), "--out",
                                      str(tmp_path / "out")])
    with pytest.raises(ImportError, match="load_scene_pack"):
        mod.main()
