"""The separate-classifier (3G6c) model at the tiny config, JAX package
against the port on the CPU.

The unit functions of models/separate_classifier.py bit equal to JAX's
(mirroring tests/test_separate_classifier.py). Then the G = 3 model with
one JAX parameter tree, converted by ``convert_jax_params``: one JAX
``init``, one jitted ``value_and_grad`` of the training forward with
``eval_in_train=1`` (losses, gradients and the train-time detections)
and one jitted predict (a module fixture each). The port takes JAX's
per-group sampler draws (``fold_in(rng, gi)`` over the anchors,
``fold_in(rng, 1000 + gi)`` over the proposals).

The tiny config's anchors are class-matched, as a 6-class config's are:
a 6 x 6 x 0.8 slab anchor on the finest 3D map (whose sites carry real
z, so the ceiling is reached too), a wall and a door anchor. With
wall-sized anchors only, a slab's best anchor quality stays far below
the foreground threshold, and its anchors are then matched by exact
ties of that best quality, which last-ulp roundings decide: there the
JAX package's jitted and eager forwards disagree with each other
(ROADMAP Queue 3).

Tolerances: detections equal as sets (valid rows sorted by (label,
score), equal labels, boxes and scores within 1e-4) with equal
``true_num``; each of the 12 losses within rtol 1e-5; gradients within
atol 1e-5 + rtol 1e-3 (as tests/test_torch_train_step.py).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.config import defaults as jdefaults
from detection_3d_tpu.engine.inference import make_predict_fn as j_predict_fn
from detection_3d_tpu.models import separate_classifier as jsep
from detection_3d_tpu.models.detector import (
    SparseRCNN as JRCNN, voxelize_points as jvox)
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu_torch.config import defaults as tdefaults
from detection_3d_tpu_torch.data import pyramid_packing as tpyr
from detection_3d_tpu_torch.data.packing import (
    batch_to_device, to_device, unpack_table)
from detection_3d_tpu_torch.data.synthetic import synthetic_building
from detection_3d_tpu_torch.engine.inference import (
    make_predict_fn, pad_scene, run_inference)
from detection_3d_tpu_torch.engine.trainer import (
    Trainer, grads_finite, total_loss)
from detection_3d_tpu_torch.models import separate_classifier as tsep
from detection_3d_tpu_torch.models.detector import (
    SparseRCNN, voxelize_points)
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from test_torch_common import cfg_pair, tiny_cfg, to_numpy_tree

CLASSES6 = ("background", "wall", "door", "window", "ceiling", "floor")
GROUPS = (("wall",), ("ceiling", "floor"))
G = 3


def sep_cfg(mod, **kw):
    """The tiny config (tests/test_torch_common.tiny_cfg) with 6 classes,
    the 3G6c groups and class-matched anchors (slab, wall, door)."""
    rpn = mod.RPNConfig(
        rpn_scales_from_top=(2, 1), rpn_3d_2d_selector=(0, 1, 2),
        anchor_sizes_3d=((6.0, 6.0, 0.8), (0.4, 1.5, 3), (0.2, 0.5, 3)),
        use_yaws=(1, 1, 1),
        fpn_pre_nms_top_n_train=256, fpn_pre_nms_top_n_test=256,
        fpn_post_nms_top_n_train=64, fpn_post_nms_top_n_test=64,
        batch_size_per_image=64)
    return tiny_cfg(mod, classes=CLASSES6, separate_classes=GROUPS, rpn=rpn,
                    **kw)


def sep_pair(**kw):
    return sep_cfg(jdefaults, **kw), sep_cfg(tdefaults, **kw)


def sep_scene(seed=0):
    return synthetic_building(seed=seed, num_points=6000, room=6.0,
                              classes=CLASSES6, voxel_scale=20)


def _rows(boxes, valid, scores, labels):
    a = np.c_[np.asarray(boxes), np.asarray(scores),
              np.asarray(labels).astype(np.float32)][np.asarray(valid)]
    return a[np.lexsort((a[:, 7], a[:, 8]))]


def _assert_same_set(got, want):
    assert want.shape[0] > 0
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 8], want[:, 8])
    np.testing.assert_allclose(got[:, :8], want[:, :8], atol=1e-4, rtol=0)


def jax_priorities(rng, shapes):
    """JAX's per-group draws under the port's priority keys ("rpn",
    "roi" with one group, "rpn_{gi}", "roi_{gi}" with G)."""
    out = {}
    for k, n in shapes.items():
        kind, _, gi = k.partition("_")
        salt = int(gi or 0) + (1000 if kind == "roi" else 0)
        out[k] = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(rng, salt), (n,))))
    return out


# ---- the unit functions ----------------------------------------------------


def test_grouped_class_ids_match_jax():
    jc, tc = sep_pair()
    assert tsep.grouped_class_ids(tc) == jsep.grouped_class_ids(jc)
    # canonical labels: wall 1, window 2, door 3, floor 4, ceiling 5;
    # group 0 the remaining ids with background, fresh backgrounds 6, 7
    assert tsep.grouped_class_ids(tc) == ((0, 2, 3), (6, 1), (7, 4, 5))
    np.testing.assert_array_equal(tsep.org_to_group_local(tc).numpy(),
                                  np.asarray(jsep.org_to_group_local(jc)))


def test_separate_targets_match_jax():
    jc, tc = sep_pair()
    rng = np.random.RandomState(0)
    boxes = rng.uniform(0.1, 5, (12, 7)).astype(np.float32)
    labels = rng.randint(0, 6, 12).astype(np.int32)
    valid = rng.rand(12) > 0.2
    jout = jsep.separate_targets(jc, JBoxes3D(jnp.asarray(boxes),
                                              jnp.asarray(valid)),
                                 jnp.asarray(labels))
    tout = tsep.separate_targets(tc, Boxes3D(torch.from_numpy(boxes),
                                             torch.from_numpy(valid)),
                                 torch.from_numpy(labels))
    assert len(tout) == len(jout) == G
    for (jb, jl), (tb, tl) in zip(jout, tout):
        np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tl.dtype == torch.int32
        np.testing.assert_array_equal(tb.boxes.numpy(), boxes)
    member = np.stack([tb.valid.numpy() for tb, _ in tout])
    np.testing.assert_array_equal(member.sum(0), valid.astype(int))


@pytest.mark.parametrize("gi", range(G))
def test_slice_group_logits_matches_jax(gi):
    jc, tc = sep_pair()
    rng = np.random.RandomState(gi)
    logits = rng.randn(5, 8).astype(np.float32)
    reg = rng.randn(5, 8 * 7).astype(np.float32)
    jl, jr = jsep.slice_group_logits(jc, jnp.asarray(logits),
                                     jnp.asarray(reg), gi)
    tl, tr = tsep.slice_group_logits(tc, torch.from_numpy(logits),
                                     torch.from_numpy(reg), gi)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_merge_group_detections_matches_jax():
    jc, tc = sep_pair()
    rng = np.random.RandomState(3)
    jd, td = [], []
    for grp in tsep.grouped_class_ids(tc):
        boxes = rng.randn(4, 7).astype(np.float32)
        valid = rng.rand(4) > 0.3
        scores = rng.rand(4).astype(np.float32)
        labels = rng.randint(0, len(grp) + 1, 4).astype(np.int32)
        jd.append(JBoxes3D(jnp.asarray(boxes), jnp.asarray(valid),
                           {"scores": jnp.asarray(scores),
                            "labels": jnp.asarray(labels)}))
        td.append(Boxes3D(torch.from_numpy(boxes), torch.from_numpy(valid),
                          {"scores": torch.from_numpy(scores),
                           "labels": torch.from_numpy(labels)}))
    jm, tm = jsep.merge_group_detections(jc, jd), \
        tsep.merge_group_detections(tc, td)
    np.testing.assert_array_equal(tm.boxes.numpy(), np.asarray(jm.boxes))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    for k in ("scores", "labels"):
        np.testing.assert_array_equal(tm.fields[k].numpy(),
                                      np.asarray(jm.fields[k]))
    assert tm.fields["labels"].dtype == torch.int32


# ---- the G = 3 model against JAX ------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """JAX params; the training forward's losses, gradients and train-time
    detections (eval_in_train=1); the predict's packed output."""
    jcfg, tcfg = sep_pair(eval_in_train=1)
    batch = pad_scene(tcfg, sep_scene())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    table = jvox(jcfg, jb["points"], jb["feats"], jb["points_valid"])
    gt = JBoxes3D(jb["gt_boxes"], jb["gt_valid"])
    rng = jax.random.PRNGKey(0)
    model = JRCNN(jcfg)
    params = jax.jit(lambda k: model.init(k, table, is_train=False))(rng)

    @jax.jit
    def value_and_grad(params):
        def loss_fn(p):
            losses, dets = model.apply(p, table, gt, jb["gt_labels"],
                                       is_train=True, rng=rng)
            return sum(jax.tree_util.tree_leaves(losses)), (losses, dets)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (total, (losses, dets)), grads = value_and_grad(params)
    out, true_num = j_predict_fn(jcfg.replace(eval_in_train=0))(params, jb)
    return {"cfg": tcfg, "batch": batch, "params": to_numpy_tree(params),
            "total": float(total),
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": convert_jax_params(to_numpy_tree(grads)),
            "train_rows": _rows(dets.boxes, dets.valid,
                                dets.fields["scores"],
                                dets.fields["labels"]),
            "out": np.asarray(out), "true_num": int(true_num),
            "priorities": jax_priorities(
                rng, SparseRCNN(tcfg).priority_shapes())}


@pytest.fixture(scope="module")
def port_run(jax_run):
    cfg = jax_run["cfg"]
    model = SparseRCNN(cfg).load_jax_params(jax_run["params"])
    (pts, fts, valid), gt, gt_labels = batch_to_device(jax_run["batch"],
                                                       "cpu")
    losses, dets = model(voxelize_points(cfg, pts, fts, valid), gt,
                         gt_labels, priorities=jax_run["priorities"])
    total = total_loss(losses)
    total.backward()
    return model, {k: float(v.detach()) for k, v in losses.items()}, \
        float(total.detach()), dets


def test_priority_shapes_per_group():
    _, tcfg = sep_pair()
    shapes = SparseRCNN(tcfg).priority_shapes()
    assert list(shapes) == ["rpn_0", "rpn_1", "rpn_2",
                            "roi_0", "roi_1", "roi_2"]
    one = SparseRCNN(cfg_pair()[1]).priority_shapes()
    assert list(one) == ["rpn", "roi"]
    assert shapes["rpn_0"] == one["rpn"]
    # the 1.5 / G rescale of the post-NMS top-n
    assert shapes["roi_0"] == tcfg.rpn_post_nms_top_n_train + \
        tcfg.caps.max_gt


def test_converted_tree_loads_strictly(jax_run):
    """The G-group JAX tree (RPN head columns a*G and a*7*G, one ROI
    predictor of num_classes + G - 1 classes) lands leaf for leaf."""
    params = jax_run["params"]
    model = SparseRCNN(jax_run["cfg"]).load_jax_params(params)
    assert len(model.state_dict()) == len(jax.tree_util.tree_leaves(params))
    a = jax_run["cfg"].rpn.num_anchors_per_location
    assert model.rpn.head.box_w.shape[1] == a * 7 * G
    assert model.roi_head.predictor.cls_w.shape[1] == 6 + G - 1
    bad = copy.deepcopy(params)
    bad["params"]["rpn"]["head"]["cls_w"] = np.zeros((16, a),
                                                     np.float32)
    with pytest.raises(RuntimeError):
        SparseRCNN(jax_run["cfg"]).load_jax_params(bad)


def test_predict_matches_jax(jax_run):
    cfg = jax_run["cfg"].replace(eval_in_train=0)
    model = SparseRCNN(cfg).load_jax_params(jax_run["params"])
    out, true_num = make_predict_fn(cfg, model, device="cpu")(
        jax_run["batch"])
    assert int(true_num) == jax_run["true_num"]
    assert out.shape == jax_run["out"].shape == \
        (G * cfg.roi_detections_per_img, 10)
    a = jax_run["out"]
    want = _rows(a[:, :7], a[:, 9] > 0.5, a[:, 7], a[:, 8])
    b = out.numpy()
    _assert_same_set(_rows(b[:, :7], b[:, 9] > 0.5, b[:, 7], b[:, 8]), want)
    labels = b[b[:, 9] > 0.5, 8]
    assert labels.min() >= 1 and labels.max() <= 5


@pytest.mark.parametrize("name", [
    f"loss_{k}_{gi}" for gi in range(G)
    for k in ("objectness", "rpn_box_reg", "classifier_roi",
              "box_reg_roi")])
def test_loss_matches_jax(jax_run, port_run, name):
    losses = port_run[1]
    assert len(losses) == 4 * G
    assert set(losses) == set(jax_run["losses"])
    np.testing.assert_allclose(losses[name], jax_run["losses"][name],
                               rtol=1e-5, atol=0)


def test_total_loss_matches_jax(jax_run, port_run):
    np.testing.assert_allclose(port_run[2], jax_run["total"], rtol=1e-5)


@pytest.mark.parametrize("part", ["backbone", "rpn", "roi_head"])
def test_gradients_match_jax(jax_run, port_run, part):
    model = port_run[0]
    checked = 0
    for name, p in model.named_parameters():
        if not name.startswith(part + "."):
            continue
        want = jax_run["grads"][name].numpy()
        assert (p.grad is None) == (not want.any()), name
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        checked += 1
    assert checked > 0


def test_rpn_head_columns_per_group(jax_run, port_run):
    """Every group's RPN head columns get their own gradient: a group
    whose columns were taken from another's would leave these zero."""
    grad = port_run[0].rpn.head.cls_w.grad.numpy()
    a = jax_run["cfg"].rpn.num_anchors_per_location
    assert grad.shape[1] == a * G
    per_group = np.abs(grad.reshape(-1, a, G)).sum((0, 1))
    assert np.all(per_group > 0)


def test_train_time_detections_match_jax(jax_run, port_run):
    dets = port_run[3]
    assert not dets.boxes.requires_grad
    got = _rows(dets.boxes, dets.valid, dets.fields["scores"],
                dets.fields["labels"])
    _assert_same_set(got, jax_run["train_rows"])


def test_run_inference_labels_are_original_ids(jax_run):
    cfg = jax_run["cfg"].replace(eval_in_train=0)
    model = SparseRCNN(cfg).load_jax_params(jax_run["params"])
    preds, result, _ = run_inference(cfg, model, [sep_scene(0),
                                                  sep_scene(1)],
                                     device="cpu", evaluate=True)
    for p in preds:
        assert p["labels"].size and p["labels"].min() >= 1 \
            and p["labels"].max() <= 5
    assert result.ap.shape == (cfg.num_classes,)


def test_packed_step_equals_the_table_step(jax_run, tmp_path):
    """The packed training step (host pyramid with backward books) gives
    the bits of the step on the same pack's voxel table, with groups."""
    cfg = jax_run["cfg"].replace(eval_in_train=0)
    pri = jax_run["priorities"]
    packed = tpyr.pack_pyramid(cfg, sep_scene(), backward=True)
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    base = SparseRCNN(cfg).load_jax_params(jax_run["params"])

    s_table = trainer.init_state(model=copy.deepcopy(base))
    b = to_device(packed, "cpu")
    losses_t = s_table.model(unpack_table(cfg, b),
                             Boxes3D(b["gt_boxes"], b["gt_valid"]),
                             b["gt_labels"], priorities=pri)
    total_t = total_loss(losses_t)
    total_t.backward()
    s_table.solver.apply(grads_finite(total_t, s_table.solver.params))

    state = trainer.init_state(model=copy.deepcopy(base))
    total, losses, ok, _ = trainer.step(state, packed, priorities=pri,
                                        packed="pyramid")
    assert ok and len(losses) == 4 * G
    assert total == float(total_t.detach())
    assert losses == {k: float(v.detach()) for k, v in losses_t.items()}
    for (n, p), q in zip(state.model.named_parameters(),
                         s_table.model.parameters()):
        assert torch.equal(p, q), n
