"""The yardstick on the CPU: the counts of work against a hand count on
a tiny building, and the frozen reference against the port's plain
path (the port's kernels fall back to their plain versions on the CPU,
so the two compute the same arithmetic there)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import counts, spec
from perfbench.inputs import load, make_weights, meta_model
from perfbench.reference.config import Config as RefConfig
from perfbench.tests import tiny
from perfbench.traffic.pool import make_pool

torch.set_num_threads(2)
DETECTOR = spec.family(spec.ROOT, "sparse_rcnn")


def _cfg(cls, **kw):
    return spec.build_config(cls, {"model": tiny.tiny_model()}, kw)


def _shapes(model_cls, cfg):
    return {k: tuple(v.shape)
            for k, v in meta_model(model_cls, cfg).state_dict().items()}


def _plane_building(n: int):
    """An n x n plane of voxels at z = 0, one point a voxel."""
    xy = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  -1).reshape(-1, 2)
    pts = np.concatenate([xy, np.zeros((len(xy), 1))], 1) + 0.5
    return {"points": pts.astype(np.float32),
            "feats": np.ones((len(xy), 9), np.float32),
            "gt_boxes": np.zeros((0, 7), np.float32),
            "gt_labels": np.zeros((0,), np.int32)}


def test_counts_match_a_hand_count():
    cfg = _cfg(RefConfig)
    work = DETECTOR.building_work(
        cfg, DETECTOR.reference_pad(cfg, _plane_building(3)), "cpu")
    convs = {c.name: c for c in work["a_convs"]}
    c_in = convs["conv_in"]
    # a 3 x 3 plane: 4 corners see 4 voxels, 4 edges 6, the centre 9
    assert (c_in.pairs, c_in.rows_in, c_in.rows_out) == (4 * 4 + 4 * 6 + 9,
                                                         9, 9)
    assert c_in.flops == 2 * 49 * 9 * 8
    assert c_in.bytes(2) == 2 * (9 * 9 + 9 * 8 + 27 * 9 * 8) + 4 * 27 * 9
    # stride 2: every fine voxel meets one of the 2 x 2 coarse voxels
    d1 = convs["down1"]
    assert (d1.pairs, d1.rows_in, d1.rows_out, d1.k) == (9, 9, 4, 8)
    assert d1.flops == 2 * 9 * 8 * 16
    # the convs the forward computes: no decoder level below the deepest
    # map a head reads (the tiny model reads 2 from the top)
    assert "up2" in convs and "up1" not in convs and "merge1" not in convs
    peak = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    least = counts.least_seconds([c_in], 2, peak, "bfloat16")
    assert least == max(c_in.flops / 989e12, c_in.bytes(2) / 3.35e12)


def test_reference_serves_as_the_port_does():
    from detection_3d_tpu_torch.config.defaults import Config
    from detection_3d_tpu_torch.engine.inference import make_predict_fn
    from detection_3d_tpu_torch.engine.trainer import (
        pad_scene, unpack_detections)
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from perfbench.reference.detector import SparseRCNN as RefRCNN
    cfg, ref_cfg = _cfg(Config), _cfg(RefConfig)
    weights = make_weights(_shapes(SparseRCNN, cfg), 11, "cpu",
                           DETECTOR.init_std)
    port = load(meta_model(SparseRCNN, cfg), weights, "cpu")
    ref = load(meta_model(RefRCNN, ref_cfg), weights, "cpu")
    predict = make_predict_fn(cfg, port, "cpu")
    pool = make_pool(12, tiny.BUILDINGS, cfg.classes, workers=1)[:2]
    run = SimpleNamespace(ref_cfg=ref_cfg, pool=pool, device="cpu")
    for i, b in enumerate(pool):
        out, _ = predict(pad_scene(cfg, b))
        got = unpack_detections(out.numpy())
        want = DETECTOR.reference_answer(run, ref, i)
        assert len(got["scores"]) > 0
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("groups", [(), (("wall",), ("ceiling", "floor"))])
def test_reference_trains_as_the_port_does(groups, tmp_path):
    from detection_3d_tpu_torch.config.defaults import Config
    from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from perfbench.reference import train as ref_train
    from perfbench.reference.detector import SparseRCNN as RefRCNN
    from perfbench.reference.solver import Solver
    from perfbench.train import draws
    sc = [list(g) for g in groups]
    cfg = _cfg(Config, separate_classes=sc)
    ref_cfg = _cfg(RefConfig, separate_classes=sc)
    weights = make_weights(_shapes(SparseRCNN, cfg), 13, "cpu",
                           DETECTOR.init_std)
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    state = trainer.init_state(model=load(meta_model(SparseRCNN, cfg),
                                          weights, "cpu"))
    ref = load(meta_model(RefRCNN, ref_cfg), weights, "cpu").train()
    solver = Solver(ref_cfg, ref, 1)
    gen = torch.Generator().manual_seed(3)
    for b in make_pool(14, tiny.BUILDINGS, cfg.classes, workers=1)[:2]:
        pri = draws(state.model.priority_shapes(), gen, "cpu")
        _, got, _, _ = trainer.step(state, pad_scene(cfg, b),
                                    priorities=pri)
        want = ref_train.step(ref_cfg, ref, solver,
                              ref_train.pad_scene(ref_cfg, b), pri, "cpu")
        assert set(got) == set(want) and len(want) == 4 * max(1, len(sc) + 1)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7)
    for (n, p), q in zip(state.model.named_parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=n)
