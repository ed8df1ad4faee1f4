"""The training pieces of the port against the JAX package, on the CPU:
matcher and sampler (bit exact, the JAX draws handed to the port), the
four losses (rtol 1e-6), RPN and ROI targets (labels equal, regression
targets within 1e-5) and the LR schedule (rtol 1e-6 over 1000 steps).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.engine import solver as jsolver
from detection_3d_tpu.models import losses as jlosses
from detection_3d_tpu.models import matcher as jmatcher
from detection_3d_tpu.models.roi_head import roi_targets as j_roi_targets
from detection_3d_tpu.models.rpn import rpn_targets as j_rpn_targets
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu_torch.engine import solver as tsolver
from detection_3d_tpu_torch.models import losses as tlosses
from detection_3d_tpu_torch.models import matcher as tmatcher
from detection_3d_tpu_torch.models.roi_head import roi_targets
from detection_3d_tpu_torch.models.rpn import rpn_targets
from detection_3d_tpu_torch.models.structures import Boxes3D
from test_torch_common import cfg_pair, tiny_scene


def _t(a):
    return torch.from_numpy(np.array(a))


def _quality(seed, m=12, n=400):
    """IoU-like quality with exact zeros, ties and padded rows/columns."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(0, 1, (m, n)).astype(np.float32)
    q[rng.uniform(size=(m, n)) < 0.5] = 0.0
    q[:, 7] = q[:, 3]                       # tied columns
    q[2] = 0.0                              # a gt with no overlap at all
    gv = np.arange(m) < m - 2
    av = rng.uniform(size=n) < 0.9
    ydif = rng.uniform(-1.57, 1.57, (m, n)).astype(np.float32)
    return q, gv, av, ydif


@pytest.mark.parametrize("low_quality", [True, False])
@pytest.mark.parametrize("yaw", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_boxes_bit_exact(low_quality, yaw, seed):
    q, gv, av, ydif = _quality(seed)
    kw = dict(high=0.55, low=0.2, allow_low_quality=low_quality,
              yaw_threshold=0.7)
    want = jmatcher.match_boxes(jnp.asarray(q), jnp.asarray(gv),
                                jnp.asarray(av),
                                yaw_diff=jnp.asarray(ydif) if yaw else None,
                                **kw)
    got = tmatcher.match_boxes(_t(q), _t(gv), _t(av),
                               yaw_diff=_t(ydif) if yaw else None, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch,frac", [(64, 0.5), (512, 0.25), (8, 0.5)])
def test_balanced_sample_bit_exact(batch, frac):
    rng = np.random.RandomState(batch)
    labels = rng.choice([-1.0, 0.0, 1.0], 3000, p=[0.2, 0.7, 0.1])
    key = jax.random.PRNGKey(batch)
    pos, neg = jmatcher.balanced_sample(jnp.asarray(labels), key, batch,
                                        frac)
    pri = _t(jax.random.uniform(key, labels.shape))
    tpos, tneg = tmatcher.balanced_sample(_t(labels), pri, batch, frac)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tneg.numpy(), np.asarray(neg))
    assert int(tpos.sum()) <= int(batch * frac)


def _loss_inputs(seed, n=300):
    rng = np.random.RandomState(seed)
    pred = rng.normal(0, 1, (n, 7)).astype(np.float32)
    target = (pred + rng.normal(0, 0.3, (n, 7))).astype(np.float32)
    target[::9] = pred[::9]                 # exact zeros of |diff|
    anchors = rng.uniform(-2, 2, (n, 7)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.6
    return pred, target, anchors, mask


@pytest.mark.parametrize("mode", ["Diff", "SinDiff", "SinDiff_2"])
def test_yaw_and_box_losses(mode):
    pred, target, anchors, mask = _loss_inputs(3)
    want = jlosses.yaw_loss(jnp.asarray(pred[:, 6]), jnp.asarray(target[:, 6]),
                            jnp.asarray(anchors[:, 6]), mode)
    got = tlosses.yaw_loss(_t(pred[:, 6]), _t(target[:, 6]),
                           _t(anchors[:, 6]), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for beta in (1.0 / 9, 1.0 / 5):
        want = jlosses.smooth_l1_box_loss(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(anchors),
            jnp.asarray(mask), beta, mode)
        got = tlosses.smooth_l1_box_loss(_t(pred), _t(target), _t(anchors),
                                         _t(mask), beta, mode)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_bce_and_cross_entropy():
    rng = np.random.RandomState(4)
    logits = rng.normal(0, 3, 500).astype(np.float32)
    logits[::11] = 0.0
    labels = rng.choice([0.0, 1.0], 500).astype(np.float32)
    mask = rng.uniform(size=500) < 0.5
    want = jlosses.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(mask))
    got = tlosses.bce_with_logits(_t(logits), _t(labels), _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    logits5 = rng.normal(0, 2, (200, 5)).astype(np.float32)
    cls = rng.randint(-1, 5, 200).astype(np.int32)
    m2 = cls >= 0
    want = jlosses.cross_entropy(jnp.asarray(logits5), jnp.asarray(cls),
                                 jnp.asarray(m2))
    got = tlosses.cross_entropy(_t(logits5), _t(cls), _t(m2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an empty mask gives 0, not NaN
    none = np.zeros(200, bool)
    assert float(tlosses.cross_entropy(_t(logits5), _t(cls), _t(none))) == 0


def _gt_and_candidates(tcfg, seed):
    """The tiny building's gt (padded to max_gt) and candidate boxes
    jittered around it, with some padded rows."""
    from detection_3d_tpu_torch.engine.trainer import pad_scene
    b = pad_scene(tcfg, tiny_scene(seed))
    rng = np.random.RandomState(seed)
    m = int(b["gt_valid"].sum())
    base = b["gt_boxes"][rng.randint(0, m, 600)]
    cand = base + np.c_[rng.normal(0, 0.3, (600, 3)),
                        rng.normal(0, 0.2, (600, 3)),
                        rng.normal(0, 0.3, (600, 1))].astype(np.float32)
    cand[:, 3:6] = np.abs(cand[:, 3:6]) + 0.05
    cvalid = rng.uniform(size=600) < 0.9
    return b, cand.astype(np.float32), cvalid


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_targets_match_jax(seed):
    jcfg, tcfg = cfg_pair()
    b, cand, cvalid = _gt_and_candidates(tcfg, seed)
    jl, jr, jm = j_rpn_targets(
        jcfg, JBoxes3D(jnp.asarray(cand), jnp.asarray(cvalid)),
        JBoxes3D(jnp.asarray(b["gt_boxes"]), jnp.asarray(b["gt_valid"])))
    tl, tr, tm = rpn_targets(tcfg, Boxes3D(_t(cand), _t(cvalid)),
                             Boxes3D(_t(b["gt_boxes"]), _t(b["gt_valid"])))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tl.numpy() == 1).sum() > 0 and (tl.numpy() == 0).sum() > 0
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_roi_targets_match_jax(seed):
    jcfg, tcfg = cfg_pair()
    b, cand, cvalid = _gt_and_candidates(tcfg, seed)
    jl, jr = j_roi_targets(
        jcfg, JBoxes3D(jnp.asarray(cand), jnp.asarray(cvalid)),
        JBoxes3D(jnp.asarray(b["gt_boxes"]), jnp.asarray(b["gt_valid"])),
        jnp.asarray(b["gt_labels"]))
    tl, tr = roi_targets(tcfg, Boxes3D(_t(cand), _t(cvalid)),
                         Boxes3D(_t(b["gt_boxes"]), _t(b["gt_valid"])),
                         _t(b["gt_labels"]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tl.numpy() > 0).sum() > 0 and (tl.numpy() == 0).sum() > 0
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("method,warmup,milestones", [
    ("linear", 500, (300, 700)), ("constant", 200, (600,)),
    ("linear", 0, ()), ("none", 100, (50, 900))])
def test_schedule_matches_jax(method, warmup, milestones):
    args = (1e-3, 1.0 / 3, warmup, method, milestones, 0.1)
    js = jsolver.warmup_multistep_schedule(*args)
    ts = tsolver.warmup_multistep_schedule(*args)
    steps = np.arange(1000)
    want = np.asarray(jax.vmap(js)(jnp.asarray(steps)))
    got = np.array([ts(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_bias_groups_follow_jax_names():
    """Bias: the last name part is ``bias`` or ends in ``_b``."""
    _, tcfg = cfg_pair()
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    model = SparseRCNN(tcfg)
    s = tsolver.Solver(tcfg, model)
    biases = {id(p) for p in s.optimizer.param_groups[1]["params"]}
    for name, p in model.named_parameters():
        last = name.rsplit(".", 1)[-1]
        assert (id(p) in biases) == (last == "bias" or last.endswith("_b"))
    assert s.optimizer.param_groups[1]["weight_decay"] == \
        tcfg.solver.weight_decay_bias
    assert len(biases) > 0
