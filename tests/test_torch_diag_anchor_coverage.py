"""The port's twin of tools/diag_anchor_coverage.py
(detection_3d_tpu_torch/tools/diag_anchor_coverage.py) on the CPU
against the JAX tool's ``main(seeds=(0,), verbose=False)``: per class,
``n_gt``, ``covered`` and ``rescued`` equal and every box's best quality
within 1e-4. Why 1e-4 and not 1e-5: the quality is a rotated IoU of a
thin wall against an anchor at building coordinates, where the two
packages round f32 corners in other orders; one pair's IoU is held at
1e-4 for that reason in tests/test_torch_evaluation.py:12-17, and one
wall's best quality here differs by 1.15e-5 (0.902336 against 0.902324).

The fast case runs both at gen_config() with small capacities on a
6000-point draw of the same building: the JAX tool reads its config and
building from tools/generalization_check.gen_config and
detection_3d_tpu.data.synthetic.synthetic_varied_building when it is
called, so the test replaces those two names for the call. The case at
the full gen_config() (35k points) is ``slow``, as the JAX tool's own
test (tests/test_synthetic_varied.py:125-153), and asserts what that
test asserts.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import test_torch_common  # noqa: F401 (one torch thread per worker)
import tools.generalization_check as jgen_tool
from detection_3d_tpu.config import defaults as jdefaults
from detection_3d_tpu.data import synthetic as jsyn
from detection_3d_tpu_torch.config import defaults as tdefaults
from detection_3d_tpu_torch.data import synthetic as tsyn
from detection_3d_tpu_torch.tools import diag_anchor_coverage as tdiag
from detection_3d_tpu_torch.tools import generalization_check as tgen

ROOT = Path(__file__).resolve().parent.parent
SMALL_POINTS = 6000
BEST_TOL = 1e-4     # one pair's IoU, f32 at building coordinates


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_diag_anchor_coverage", ROOT / "tools" / "diag_anchor_coverage.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(cfg, mod):
    return dataclasses.replace(cfg, caps=mod.CapacityConfig(
        max_points=8192, voxel_caps=(8192, 4096, 2048, 1024, 512),
        max_gt=64, dense_grid_max_entries=1 << 26))


def _scene(cfg, num_points):
    return tsyn.synthetic_varied_building(
        seed=0, num_points=num_points, classes=cfg.classes,
        voxel_scale=cfg.sparse3d.voxel_scale)


def _assert_same(got, want):
    assert set(got) == set(want)
    for cname, w in want.items():
        g = got[cname]
        for key in ("n_gt", "covered", "rescued"):
            assert g[key] == w[key], (cname, key, g, w)
        np.testing.assert_allclose(g["best"], w["best"], atol=BEST_TOL,
                                   rtol=0, err_msg=cname)


def test_coverage_matches_the_jax_tool(monkeypatch):
    jcfg = _small(jgen_tool.gen_config(), jdefaults)
    tcfg = _small(tgen.gen_config(), tdefaults)
    real = jsyn.synthetic_varied_building
    monkeypatch.setattr(jgen_tool, "gen_config", lambda: jcfg)
    monkeypatch.setattr(jsyn, "synthetic_varied_building",
                        lambda **kw: real(**{**kw,
                                             "num_points": SMALL_POINTS}))
    want = _jax_tool().main(seeds=(0,), verbose=False)
    got = tdiag.coverage(tcfg, [_scene(tcfg, SMALL_POINTS)], "cpu")
    _assert_same(got, want)
    assert sum(st["n_gt"] for st in got.values()) > 0
    assert sum(st["covered"] for st in got.values()) > 0


def test_scene_coverage_rows_add_up():
    tcfg = _small(tgen.gen_config(), tdefaults)
    scene = _scene(tcfg, SMALL_POINTS)
    rows, info = tdiag.scene_coverage(tcfg, scene, "cpu")
    assert len(rows) == info["n_gt"] == int((scene["gt_labels"] > 0).sum())
    assert 0 < info["anchors_valid"] <= info["anchors"]
    for r in rows:
        # a box with an anchor above the threshold is matched to one
        assert r["above"] == 0 or r["assigned"] > 0, r
        assert (r["best"] >= tcfg.rpn.fg_iou_threshold) == (r["above"] > 0)



@pytest.mark.slow
def test_gen_config_coverage_matches_the_jax_tool():
    """At the full gen_config() on the 35k-point building of seed 0: the
    JAX tool's numbers, and its test's assertions (every wall, door and
    floor covered, ceilings all but two, no orphans)."""
    want = _jax_tool().main(seeds=(0,), verbose=False)
    got = tdiag.main(seeds=(0,), verbose=False, device="cpu")
    _assert_same(got, want)
    for cname in ("wall", "door", "floor"):
        assert got[cname]["n_gt"] > 0
        assert got[cname]["covered"] == got[cname]["n_gt"], got[cname]
    ceil = got["ceiling"]
    assert ceil["covered"] >= ceil["n_gt"] - 2, ceil
    for cname, st in got.items():
        if st["n_gt"]:
            assert st["n_gt"] - st["covered"] - st["rescued"] == 0, cname
