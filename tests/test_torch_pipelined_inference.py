"""Batched and pipelined serving, on the CPU, with seeded weights.

1. make_batch_predict_fn on two stacked buildings against the
   per-building predict: bit equal, for each packed form.
2. run_inference(pipelined=True) for both pack modes and batch sizes 1
   and 2 (three buildings, so the batched run pads its tail unit)
   against the sequential packed predict on the same C++ packs, within
   1e-6, with its ``timings``; one pack worker, and the evaluation of
   the pipelined detections.
3. The port's repairs of two faults it shares with the JAX package:
   batch_size > 1 without ``pipelined`` raises, and a run that timed no
   building returns NaN s/building with a warning, on both paths.
"""

import logging
import math

import numpy as np
import pytest
import torch

from detection_3d_tpu_torch.data.native_packer import (
    pack_pyramid_native, pack_table_native,
)
from detection_3d_tpu_torch.data.packing import pack_scene, pack_table
from detection_3d_tpu_torch.data.pyramid_packing import pack_pyramid
from detection_3d_tpu_torch.engine.inference import (
    make_batch_predict_fn, make_predict_fn, run_inference,
)
from detection_3d_tpu_torch.models.detector import SparseRCNN
from test_torch_common import cfg_pair, tiny_scene

PACKERS = {True: pack_scene, "table": pack_table, "pyramid": pack_pyramid}
NATIVE = {"table": pack_table_native, "pyramid": pack_pyramid_native}


@pytest.fixture(scope="module")
def weights():
    """The tiny config and a model with seeded random weights."""
    _, tcfg = cfg_pair()
    return tcfg, SparseRCNN(tcfg, seed=0)


@pytest.mark.parametrize("packed", [True, "table", "pyramid"])
def test_batch_predict_matches_sequential(weights, packed):
    tcfg, model = weights
    packs = [PACKERS[packed](tcfg, tiny_scene(s)) for s in (1, 2)]
    stacked = {k: np.stack([p[k] for p in packs]) for k in packs[0]}
    out, true_num = make_batch_predict_fn(tcfg, model, device="cpu",
                                          packed=packed)(stacked)
    assert out.shape == (2, tcfg.roi_detections_per_img, 10)
    assert true_num.shape == (2,)
    one = make_predict_fn(tcfg, model, device="cpu", packed=packed)
    for i, p in enumerate(packs):
        o, t = one(p)
        assert torch.equal(out[i], o) and int(true_num[i]) == int(t)


@pytest.fixture(scope="module")
def sequential(weights):
    """Three buildings, each mode's sequential predict on the C++ packs."""
    tcfg, model = weights
    scenes = [tiny_scene(s) for s in (3, 4, 5)]
    want = {}
    for mode, pack in NATIVE.items():
        predict = make_predict_fn(tcfg, model, device="cpu", packed=mode)
        want[mode] = [predict(pack(tcfg, s)) for s in scenes]
    return scenes, want


@pytest.mark.parametrize("batch_size", [1, 2])
@pytest.mark.parametrize("pack_mode", ["pyramid", "table"])
def test_pipelined_matches_sequential(weights, sequential, pack_mode,
                                      batch_size):
    tcfg, model = weights
    scenes, want = sequential
    timings = {}
    preds, result, sec = run_inference(
        tcfg, model, scenes, device="cpu", pipelined=True, pack_workers=2,
        pack_mode=pack_mode, batch_size=batch_size, timings=timings)
    assert result is None and sec > 0 and len(preds) == len(scenes)
    assert set(timings) == {"wait_pack", "dispatch", "drain_fetch"}
    assert all(v >= 0 for v in timings.values())
    for p, (out, true_num) in zip(preds, want[pack_mode]):
        a = out.numpy()
        v = a[:, 9] > 0.5
        assert p["true_num"] == int(true_num)
        np.testing.assert_array_equal(p["labels"], a[v, 8].astype(np.int32))
        np.testing.assert_allclose(p["boxes"], a[v, :7], atol=1e-6, rtol=0)
        np.testing.assert_allclose(p["scores"], a[v, 7], atol=1e-6, rtol=0)


def test_pipelined_one_worker_and_evaluation(weights, sequential):
    """One pack worker, and the pipelined detections scored as the
    sequential loop scores its own."""
    tcfg, model = weights
    scenes, want = sequential
    preds, result, _ = run_inference(
        tcfg, model, scenes[:2], device="cpu", pipelined=True,
        pack_workers=1, pack_mode="table", evaluate=True)
    for p, (out, _) in zip(preds, want["table"]):
        a = out.numpy()
        np.testing.assert_array_equal(p["scores"], a[a[:, 9] > 0.5, 7])
    labels = np.concatenate([s["gt_labels"] for s in scenes[:2]])
    want_gt = np.bincount(labels, minlength=tcfg.num_classes)
    want_gt[0] = 0
    np.testing.assert_array_equal(result.n_gt, want_gt)




def test_sequential_loop_refuses_a_batch_size(weights):
    tcfg, model = weights
    with pytest.raises(ValueError, match="pipelined=True"):
        run_inference(tcfg, model, [tiny_scene(3)], device="cpu",
                      batch_size=2)


@pytest.mark.parametrize("pipelined", [False, True])
def test_one_building_times_nothing(weights, sequential, pipelined, caplog):
    """One building: the first building (or unit) only warms up, so
    nothing is timed and s/building is NaN, not 0.0."""
    tcfg, model = weights
    scenes, _ = sequential
    with caplog.at_level(logging.WARNING):
        preds, _, sec = run_inference(
            tcfg, model, scenes[:1], device="cpu", pipelined=pipelined,
            pack_workers=1, pack_mode="table")
    assert len(preds) == 1 and math.isnan(sec)
    assert "no building was timed" in caplog.text
