"""The port's evaluator (evaluation/detection_eval.py) against the JAX
package's on the same predictions and ground truth, on the CPU.

The predictions are the gt boxes jittered (some twice), plus random
false positives, over classes that have gts and predictions, gts only,
predictions only, or neither; a prediction whose IoU with a gt of its
class lies near the 0.2 threshold is dropped, so that float32 rounding
cannot move it across. Expected: the same match arrays, precision,
recall and scores (exact), AP and AIoU within 1e-6, the same summary
text and result files, and each pair's IoU within 1e-4.

Why 1e-4 for one pair's IoU: a corner 20 m from the origin holds f32
rounding of ~2e-6 m, which moves a thin box's intersection area by
~1e-5 of its size; the two packages round in other orders (XLA fuses
and contracts), and each sits up to ~1e-4 from the float64 IoU on these
boxes (also at 1 m from the origin they differ by ~4e-6). The IoU
statistics rows of the detail table (IoU x 100, two decimals) may
therefore differ by one in the last digit; every other row is equal.
The unit cases of tests/test_data_pipeline.py run through the port as
well.
"""

import os

import numpy as np
import pytest

from detection_3d_tpu.evaluation import detection_eval as jeval
from detection_3d_tpu.ops.rotated_iou import boxes_iou_3d as j_iou
from detection_3d_tpu_torch.evaluation import detection_eval as teval

NAMES = ("background", "wall", "window", "door", "floor", "ceiling")
AUG = {"target_Y": 0.2, "anchor_Y": 0.2, "target_Z": 0.2, "anchor_Z": 0.2}
THRESH = 0.2
IOU_TOL = 1e-4            # one pair's IoU, f32 at building coordinates
IOU_ROWS = ("iou mean", "iou std", "iou min")


def _random_boxes(rng, n):
    """(n, 7) yx_zb boxes in a 20 m building: thin to square footprints."""
    return np.c_[rng.uniform(0, 20, (n, 2)), rng.uniform(0, 1, n),
                 rng.uniform(0.1, 3, (n, 2)), rng.uniform(0.5, 3, n),
                 rng.uniform(-np.pi / 2, np.pi / 2, n)].astype(np.float32)


def _jitter(rng, boxes, scale):
    out = boxes.copy()
    out[:, :3] += rng.normal(0, scale, (len(boxes), 3))
    out[:, 3:6] *= 1 + rng.normal(0, scale, (len(boxes), 3))
    out[:, 6] += rng.normal(0, scale, len(boxes))
    return out.astype(np.float32)


def _building(rng, b):
    """One building's gts and predictions. Classes: wall (gts and
    predictions; building 1 has no wall predictions), window (both),
    door (gts only), floor (predictions only), ceiling (neither)."""
    gt_counts = {1: 12, 2: 4, 3: 3}
    gtb, gtl, pb, pl = [], [], [], []
    for label, n in gt_counts.items():
        g = _random_boxes(rng, n)
        gtb.append(g)
        gtl.append(np.full(n, label))
        if label == 3 or (label == 1 and b == 1):
            continue
        hits = _jitter(rng, g, 0.05)
        twice = _jitter(rng, g[: n // 3], 0.1)
        fps = _random_boxes(rng, n // 2)
        p = np.concatenate([hits, twice, fps])
        pb.append(p)
        pl.append(np.full(len(p), label))
    pb.append(_random_boxes(rng, 5))
    pl.append(np.full(5, 4))
    gt = {"boxes": np.concatenate(gtb), "labels": np.concatenate(gtl)}
    pred = {"boxes": np.concatenate(pb), "labels": np.concatenate(pl)}
    pred["scores"] = rng.uniform(0, 1, len(pred["boxes"]))
    # drop predictions near the threshold against any gt of their class
    keep = np.ones(len(pred["boxes"]), bool)
    for label in np.unique(pred["labels"]):
        pm, gm = pred["labels"] == label, gt["labels"] == label
        if not gm.any():
            continue
        iou = np.asarray(j_iou(gt["boxes"][gm], pred["boxes"][pm],
                               aug_thickness=AUG, criterion=-1))
        near = (np.abs(iou - THRESH) < 0.02).any(0)
        keep[np.where(pm)[0][near]] = False
    pred = {k: v[keep] for k, v in pred.items()}
    pred["labels"] = pred["labels"].astype(np.int32)
    gt["labels"] = gt["labels"].astype(np.int32)
    return pred, gt


@pytest.fixture(scope="module")
def results():
    rng = np.random.RandomState(0)
    preds, gts = zip(*[_building(rng, b) for b in range(3)])
    kw = dict(eval_aug_thickness=AUG, class_names=NAMES)
    want = jeval.evaluate_detections(list(preds), list(gts), len(NAMES),
                                     THRESH, **kw)
    got = teval.evaluate_detections(list(preds), list(gts), len(NAMES),
                                    THRESH, device="cpu", **kw)
    return want, got


def test_case_has_every_class_kind(results):
    want, _ = results
    assert sorted(want.curves) == [1, 2]            # gts and predictions
    assert want.n_gt.tolist() == [0, 36, 12, 9, 0, 0]
    assert want.missed_rate[3] == 1.0               # door: gts only
    assert np.isnan(want.ap[4]) and np.isnan(want.ap[5])
    assert (want.curves[1]["match"] == 1).sum() > 10
    assert (want.curves[1]["match"] == 0).sum() > 5


@pytest.mark.parametrize("label", [1, 2])
@pytest.mark.parametrize("key", ["match", "prec", "rec", "score"])
def test_curves_equal(results, label, key):
    want, got = results
    assert sorted(got.curves) == sorted(want.curves)
    np.testing.assert_array_equal(got.curves[label][key],
                                  want.curves[label][key])


@pytest.mark.parametrize("label", [1, 2])
def test_curve_ious_within_f32_resolution(results, label):
    want, got = results
    np.testing.assert_allclose(got.curves[label]["iou"],
                               want.curves[label]["iou"], rtol=0,
                               atol=IOU_TOL)


def test_pair_ious_as_close_to_float64_as_jax():
    """Both packages' f32 IoUs of jittered boxes sit within 2e-4 of the
    float64 IoU (the port's plain algorithm run in float64)."""
    import torch
    from detection_3d_tpu_torch.ops import rotated_iou as tiou
    rng = np.random.RandomState(1)
    g = _random_boxes(rng, 40)
    p = _jitter(rng, g, 0.05)
    want = np.asarray(j_iou(g, p, aug_thickness=AUG, criterion=-1))
    got = tiou.boxes_iou_3d(torch.from_numpy(g), torch.from_numpy(p),
                            aug_thickness=AUG, criterion=-1).numpy()
    t, q = (torch.from_numpy(b.astype(np.float64)) for b in (g, p))
    for b, y, z in ((t, "target_Y", "target_Z"), (q, "anchor_Y", "anchor_Z")):
        b[:, 3].clamp_(min=AUG[y])
        b[:, 5].clamp_(min=AUG[z])
    cols = [0, 1, 3, 4, 6]
    truth = (tiou.rotated_iou_plain(t[:, cols], q[:, cols], -1,
                                    same_box_fix=True)
             * tiou.z_interval_iou(t[:, [2, 5]], q[:, [2, 5]])).numpy()
    assert np.abs(want - truth).max() < 2e-4
    assert np.abs(got - truth).max() < 2e-4


@pytest.mark.parametrize("field", ["ap", "aiou"])
def test_ap_and_aiou_within_1e6(results, field):
    want, got = results
    np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("field", ["n_gt", "missed_rate", "multi_rate"])
def test_counts_equal(results, field):
    want, got = results
    np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def _assert_text_matches(got, want):
    """Equal lines, but for the IoU statistics rows of the detail table,
    whose numbers may differ by one in the last printed digit."""
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if not w.startswith(IOU_ROWS):
            assert g == w
            continue
        assert g[:12] == w[:12]
        np.testing.assert_allclose(np.array(g[12:].split(), float),
                                   np.array(w[12:].split(), float),
                                   rtol=0, atol=0.0101)


def test_summary_text_equal(results):
    want, got = results
    assert got.summary() == want.summary()


def test_detail_table_matches(results):
    want, got = results
    _assert_text_matches(got.detail_table(), want.detail_table())


def test_save_results_files_equal(results, tmp_path):
    want, got = results
    paths = {}
    for name, res, mod in (("jax", want, jeval), ("port", got, teval)):
        out = tmp_path / name
        paths[name] = mod.save_results(res, str(out), 3, THRESH, epoch=2)
    with open(paths["jax"]) as f1, open(paths["port"]) as f2:
        _assert_text_matches(f2.read(), f1.read())
    zj = np.load(tmp_path / "jax" / "performance_res.npz")
    zt = np.load(tmp_path / "port" / "performance_res.npz")
    assert sorted(zt.files) == sorted(zj.files)
    assert "curve_1_match" in zt.files
    np.testing.assert_array_equal(zt["class_names"], zj["class_names"])


@pytest.mark.parametrize("helper", ["voc_ap_07", "accumulate_prec_rec",
                                    "match_predictions_to_gt"])
def test_host_helpers_equal(helper):
    rng = np.random.RandomState(3)
    if helper == "voc_ap_07":
        rec = np.sort(rng.uniform(0, 1, 40))
        prec = rng.uniform(0, 1, 40)
        prec[3] = np.nan
        args = (prec, rec)
    elif helper == "accumulate_prec_rec":
        args = (rng.uniform(0, 1, 30), rng.randint(0, 2, 30),
                rng.uniform(0, 1, 30), 12)
    else:
        args = (rng.uniform(0, 0.6, (5, 17)), THRESH)
    want = getattr(jeval, helper)(*args)
    got = getattr(teval, helper)(*args)
    if helper == "voc_ap_07":
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_no_gt_box_sizes_clamp_at_zero_as_in_jax():
    """Without an eval thickness dict both evaluators clamp the y and z
    sizes at 0 (a negative size gives the same IoU)."""
    gt = {"boxes": np.array([[1, 1, 0, 2.0, 2, 2, 0]], np.float32),
          "labels": np.array([1])}
    pred = {"boxes": np.array([[1.2, 1, 0, -1.0, 2, -2, 0]], np.float32),
            "scores": np.array([0.9]), "labels": np.array([1])}
    want = jeval.evaluate_detections([pred], [gt], 2, 0.0)
    got = teval.evaluate_detections([pred], [gt], 2, 0.0, device="cpu")
    np.testing.assert_allclose(got.curves[1]["iou"], want.curves[1]["iou"],
                               atol=1e-6)


# ---- the unit cases of tests/test_data_pipeline.py, through the port -----


def test_save_results_unit_case(tmp_path):
    preds = [{"boxes": np.zeros((0, 7), np.float32),
              "scores": np.zeros((0,)), "labels": np.zeros((0,), np.int64)}]
    gts = [{"boxes": np.array([[1, 1, 0, 0.1, 2, 2.7, 0.0]], np.float32),
            "labels": np.array([1])}]
    r = teval.evaluate_detections(preds, gts, 2, 0.2,
                                  class_names=("background", "wall"),
                                  device="cpu")
    p = teval.save_results(r, str(tmp_path), 1, 0.2, epoch=3)
    text = open(p).read()
    assert "wall" in text and "iou_thresh" in text
    assert os.path.exists(tmp_path / "performance_res.npz")


def test_detail_table_and_pr_curves_unit_case(tmp_path):
    # 3 preds: scores 0.9 TP, 0.8 TP, 0.4 FP on 2 gts
    preds = [{"boxes": np.array([[1, 1, 0, 0.1, 2, 2.7, 0.0],
                                 [4, 1, 0, 0.1, 2, 2.7, 0.0],
                                 [9, 9, 0, 0.1, 2, 2.7, 0.0]], np.float32),
              "scores": np.array([0.9, 0.8, 0.4]),
              "labels": np.array([1, 1, 1])}]
    gts = [{"boxes": np.array([[1, 1, 0, 0.1, 2, 2.7, 0.0],
                               [4, 1, 0, 0.1, 2, 2.7, 0.0]], np.float32),
            "labels": np.array([1, 1])}]
    r = teval.evaluate_detections(preds, gts, 2, 0.2,
                                  class_names=("background", "wall"),
                                  device="cpu")
    assert 1 in r.curves
    c = r.curves[1]
    np.testing.assert_allclose(c["rec"], [0.5, 1.0, 1.0])
    np.testing.assert_allclose(c["prec"], [1.0, 1.0, 2 / 3])
    assert (c["match"] == [1, 1, 0]).all()
    table = r.detail_table()
    assert "st5 prec" in table and "r9p" in table and "gt num" in table
    p = teval.save_results(r, str(tmp_path), 1, 0.2, epoch=1)
    assert "st5 prec" in open(p).read()
    assert os.path.exists(tmp_path / "pr_curves.png")
    z = np.load(tmp_path / "performance_res.npz")
    assert "curve_1_prec" in z
