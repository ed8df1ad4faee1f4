"""The port's twin of tools/profile_inference.py
(detection_3d_tpu_torch/tools/profile_inference.py) on the CPU.

Its nested prefixes against the JAX tool's on the same building and
weights (JAX's init, converted), at the tiny config: the voxelize and
pyramid prefixes' counts equal voxelize_points' num and build_pyramid's
table nums exactly, the input features' sum within rtol 1e-6; the
backbone prefix's RPN-map sum and the RPN prefix's proposal-box sum
within rtol 1e-4 (f32 sums in another order); the full prefix equal to
the port's make_predict_fn. And the timing rows: positive, in prefix
order, device fields "not measured" on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.models.backbone import (
    SparseFPN as JFPN, build_pyramid as jbuild)
from detection_3d_tpu.models.detector import (
    SparseRCNN as JRCNN, voxelize_points as jvox)
from detection_3d_tpu.models.rpn import RPN as JRPN
from detection_3d_tpu_torch.engine.inference import make_predict_fn, pad_scene
from detection_3d_tpu_torch.models.detector import SparseRCNN
from detection_3d_tpu_torch.tools import profile_inference
from test_torch_common import cfg_pair, scene_tables, tiny_scene, to_numpy_tree


@pytest.fixture(scope="module")
def prefixes():
    """The JAX tool's prefixes (tools/profile_inference.py:68-112) and
    the port's, on one building with the same weights."""
    jcfg, tcfg = cfg_pair()
    jt, _ = scene_tables(jcfg, tcfg)
    params = to_numpy_tree(jax.jit(
        lambda k: JRCNN(jcfg).init(k, jt, is_train=False))(
            jax.random.PRNGKey(0)))
    model = SparseRCNN(tcfg).load_jax_params(params)
    scene = tiny_scene(0)
    jb = {k: jnp.asarray(v) for k, v in pad_scene(tcfg, scene).items()}
    bb, rpn = JFPN(jcfg, name="backbone"), JRPN(jcfg, name="rpn")

    def table(b):
        return jvox(jcfg, b["points"], b["feats"], b["points_valid"])

    @jax.jit
    def stage_voxelize(b):
        t = table(b)
        return t.feats.sum(), t.num

    @jax.jit
    def stage_pyramid(b):
        return [x.num for x in jbuild(table(b), jcfg)["tables"]]

    def maps(b):
        t = table(b)
        return bb.apply({"params": params["params"]["backbone"]}, t,
                        jbuild(t, jcfg))

    @jax.jit
    def stage_backbone(b):
        rpn_maps, _ = maps(b)
        return sum(m.feats.sum() for m in rpn_maps)

    @jax.jit
    def stage_rpn(b):
        rpn_maps, _ = maps(b)
        props, _ = rpn.apply({"params": params["params"]["rpn"]}, rpn_maps,
                             None, is_train=False, rng=None)
        return props[0].boxes.sum()

    want = {"voxelize": stage_voxelize(jb), "+pyramid": stage_pyramid(jb),
            "+backbone": stage_backbone(jb), "+rpn": stage_rpn(jb)}
    rows, got = profile_inference.profile(tcfg, model, scene, "cpu", iters=1)
    return tcfg, model, scene, want, rows, got


def test_input_and_pyramid_counts_equal_jax(prefixes):
    _, _, _, want, _, got = prefixes
    (jsum, jnum), (tsum, tnum) = want["voxelize"], got["voxelize"]
    assert int(tnum) == int(jnum)
    np.testing.assert_allclose(float(tsum), float(jsum), rtol=1e-6)
    assert got["+pyramid"].tolist() == [int(n) for n in want["+pyramid"]]


@pytest.mark.parametrize("stage", ["+backbone", "+rpn"])
def test_backbone_and_rpn_sums_match_jax(prefixes, stage):
    _, _, _, want, _, got = prefixes
    np.testing.assert_allclose(float(got[stage]), float(want[stage]),
                               rtol=1e-4)


def test_full_prefix_is_the_predict(prefixes):
    tcfg, model, scene, _, _, got = prefixes
    out, true_num = make_predict_fn(tcfg, model, "cpu")(pad_scene(tcfg, scene))
    assert torch.equal(got["full"][0], out)
    assert int(got["full"][1]) == int(true_num)
    assert int((out[:, 9] > 0.5).sum()) > 0


def test_rows_in_prefix_order(prefixes):
    rows = prefixes[4]
    assert [r["stage"] for r in rows] == list(profile_inference.STAGES)
    assert all(r["s"] > 0 for r in rows)
    assert rows[0]["stage_s"] == rows[0]["s"]
    assert all(r["busy_ms"] is None and r["idle_share"] is None
               for r in rows)
