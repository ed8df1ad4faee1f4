"""The port's quality gates (detection_3d_tpu_torch/tools/overfit_check.py
and generalization_check.py) on the CPU: their configurations equal the
repo-level JAX tools' (tools/overfit_check.py, tools/generalization_check.py)
field for field, and each tool trains a step at its configuration with
``--device cpu``, evaluates, writes its summary and result files, and
exits 0 exactly when its gate passes (after one step it fails).
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

import test_torch_common  # noqa: F401 (one torch thread per worker)
from detection_3d_tpu_torch.tools import generalization_check as tgen
from detection_3d_tpu_torch.tools import overfit_check as tovf

ROOT = Path(__file__).resolve().parent.parent
CLASS_NAMES = {"wall", "door", "window", "ceiling", "floor"}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("output_dir")
    return d


@pytest.mark.parametrize("which", ["overfit", "overfit_groups", "gen",
                                   "gen_wide"])
def test_configs_match_the_jax_tools(which):
    jovf, jgen = _jax_tool("overfit_check"), _jax_tool("generalization_check")
    want, got = {
        "overfit": (jovf.overfit_config, tovf.overfit_config),
        "overfit_groups": (lambda: jovf.overfit_config(groups=True),
                           lambda: tovf.overfit_config(groups=True)),
        "gen": (lambda: jgen.gen_config(epochs=60),
                lambda: tgen.gen_config(epochs=60)),
        "gen_wide": (lambda: jgen.gen_config(epochs=8, base_lr=0.02,
                                             wide=True),
                     lambda: tgen.gen_config(epochs=8, base_lr=0.02,
                                             wide=True)),
    }[which]
    assert _fields(got()) == _fields(want())
    assert got().output_dir.endswith(
        "generalization_check" if which.startswith("gen") else
        "overfit_check")


def test_fullres_config_selects_one_map_per_anchor_size(monkeypatch):
    """The JAX tool's fullres_config selects 8 RPN maps for 6 anchor sizes
    and fails its own validate; the port's selects the first 6 and
    equals it in every other field."""
    from detection_3d_tpu.config.defaults import Config as JConfig
    jovf = _jax_tool("overfit_check")
    with pytest.raises(AssertionError, match="one anchor size"):
        jovf.fullres_config()
    monkeypatch.setattr(JConfig, "validate", lambda self: self)
    want = _fields(jovf.fullres_config())
    got = tovf.fullres_config()
    assert got.rpn.rpn_3d_2d_selector == (0, 1, 2, 3, 4, 5)
    assert want["rpn"]["rpn_3d_2d_selector"] == (0, 1, 2, 3, 4, 5, 6, 7)
    want["rpn"]["rpn_3d_2d_selector"] = (0, 1, 2, 3, 4, 5)
    assert _fields(got) == want
    assert got.output_dir.endswith("overfit_fullres")


def _check_summary(out, code, **want):
    summary = json.loads((out / "summary.json").read_text())
    assert code == (0 if summary["ok"] else 1)
    assert set(summary["per_class_ap"]) == CLASS_NAMES
    assert summary["device"] == "cpu"
    for k, v in want.items():
        assert summary[k] == v, k
    assert list(out.glob("result_*.txt"))
    assert (out / "performance_res.npz").exists()
    return summary


def test_overfit_check_groups_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "overfit"
    code = tovf.main(["--groups", "--steps", "1", "--chunk", "1",
                      "--device", "cpu", "--output-dir", str(out)])
    summary = _check_summary(out, code, steps=1, groups=3, scenes=1)
    assert summary["non_finite_steps"] == 0
    assert (out / "model_min_loss.pt").exists()
    printed = capsys.readouterr().out
    assert "OVERFIT CHECK:" in printed and "class ceiling" in printed


def test_generalization_check_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "gen"
    code = tgen.main(["--train-scenes", "1", "--test-scenes", "1",
                      "--epochs", "1", "--eval-train", "0",
                      "--scan-steps", "1", "--device", "cpu",
                      "--output-dir", str(out)])
    # one test building: nothing timed, its NaN s/building written null
    _check_summary(out, code, steps=1, groups=1, train_scenes=1,
                   test_scenes=1, sec_per_building=None)
    assert (out / "model_final.pt").exists()
    assert "GENERALIZATION CHECK" in capsys.readouterr().out


def test_summary_writes_nan_as_null(tmp_path):
    """summary.json stays valid JSON: NaN (a run that timed no building)
    is written as null, at any depth."""
    path = tovf.write_summary(str(tmp_path), {
        "sec_per_building": float("nan"), "ok": True,
        "per_class_ap": {"wall": float("nan"), "door": 0.5}})
    assert json.loads(Path(path).read_text()) == {
        "sec_per_building": None, "ok": True,
        "per_class_ap": {"wall": None, "door": 0.5}}
