"""Eval-in-train at the tiny config: the training forward's train-time
detections against the JAX package's ``model.apply(is_train=True)`` with
``eval_in_train=1``, and the port's Trainer pooling and evaluating them.

One JAX init and one apply per file (a module fixture); the port takes
the converted parameters and the JAX samplers' draws through
``priorities`` (as in tests/test_torch_train_step.py). The detections
must be the same set: the valid rows, sorted by (label, score), with
equal labels and boxes and scores within 1e-4; the losses within rtol
1e-5.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.models.detector import (
    SparseRCNN as JRCNN, voxelize_points as jvox)
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu_torch.data.packing import batch_to_device, pad_scene
from detection_3d_tpu_torch.engine.trainer import Trainer, total_loss
from detection_3d_tpu_torch.models.detector import (
    SparseRCNN, voxelize_points)
from test_torch_common import cfg_pair, tiny_scene, to_numpy_tree


def _rows(boxes, valid, scores, labels):
    a = np.c_[np.asarray(boxes), np.asarray(scores),
              np.asarray(labels).astype(np.float32)][np.asarray(valid)]
    return a[np.lexsort((a[:, 7], a[:, 8]))]


@pytest.fixture(scope="module")
def jax_run():
    jcfg, tcfg = cfg_pair(eval_in_train=1)
    batch = pad_scene(tcfg, tiny_scene())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    table = jvox(jcfg, jb["points"], jb["feats"], jb["points_valid"])
    gt = JBoxes3D(jb["gt_boxes"], jb["gt_valid"])
    rng = jax.random.PRNGKey(0)
    model = JRCNN(jcfg)
    params = jax.jit(functools.partial(model.init, is_train=True))(
        rng, table, gt, jb["gt_labels"], rng=rng)
    losses, dets = jax.jit(lambda p: model.apply(
        p, table, gt, jb["gt_labels"], is_train=True, rng=rng))(params)
    shapes = SparseRCNN(tcfg).priority_shapes()
    pri = {"rpn": jax.random.uniform(jax.random.fold_in(rng, 0),
                                     (shapes["rpn"],)),
           "roi": jax.random.uniform(jax.random.fold_in(rng, 1000),
                                     (shapes["roi"],))}
    return {"cfg": tcfg, "batch": batch, "params": to_numpy_tree(params),
            "losses": {k: float(v) for k, v in losses.items()},
            "rows": _rows(dets.boxes, dets.valid, dets.fields["scores"],
                          dets.fields["labels"]),
            "priorities": {k: torch.from_numpy(np.array(v))
                           for k, v in pri.items()}}


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
    return losses, dets, model


def test_train_time_detections_match_jax(jax_run, port_run):
    _, dets, _ = port_run
    want = jax_run["rows"]
    got = _rows(dets.boxes, dets.valid, dets.fields["scores"],
                dets.fields["labels"])
    assert want.shape[0] > 0
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 8], want[:, 8])
    np.testing.assert_allclose(got[:, :8], want[:, :8], atol=1e-4, rtol=0)


def test_losses_unchanged_by_eval_in_train(jax_run, port_run):
    losses, _, _ = port_run
    assert set(losses) == set(jax_run["losses"])
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), jax_run["losses"][k],
                                   rtol=1e-5, err_msg=k)


def test_detections_stay_out_of_the_graph(port_run):
    _, dets, model = port_run
    for t in (dets.boxes, dets.fields["scores"]):
        assert not t.requires_grad and t.grad_fn is None
    assert any(p.grad is not None for p in model.parameters())


def test_forward_without_eval_in_train_returns_the_losses(jax_run):
    cfg = jax_run["cfg"].replace(eval_in_train=0)
    model = SparseRCNN(cfg).load_jax_params(jax_run["params"])
    (pts, fts, valid), gt, gt_labels = batch_to_device(jax_run["batch"],
                                                       "cpu")
    with torch.no_grad():
        out = model(voxelize_points(cfg, pts, fts, valid), gt, gt_labels,
                    priorities=jax_run["priorities"])
    assert isinstance(out, dict) and set(out) == set(jax_run["losses"])


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(msg % args)

    warning = info


@pytest.mark.parametrize("every", [1, 2])
def test_trainer_evaluates_the_train_time_detections(every, tmp_path):
    """Two epochs over two buildings: every ``every``-th epoch (from
    epoch 0) is evaluated; ``last_train_eval`` counts each class's gts of
    the buildings, and ``step`` keeps its 4-tuple."""
    _, tcfg = cfg_pair(eval_in_train=every)
    log = _Log()
    trainer = Trainer(tcfg, output_dir=str(tmp_path), logger=log,
                      device="cpu")
    scenes = [tiny_scene(0), tiny_scene(1)]
    state = trainer.train(scenes, trainer.init_state(seed=0), epochs=2)
    assert len(trainer.history) == 4 and all(len(h) == 4
                                             for h in trainer.history)
    evaluated = [ln for ln in log.lines if ln.startswith("eval-in-train")]
    assert [ln.split(":")[0] for ln in evaluated] == \
        [f"eval-in-train epoch {e}" for e in range(0, 2, every)]
    res = trainer.last_train_eval
    labels = np.concatenate([s["gt_labels"] for s in scenes])
    want = np.bincount(labels, minlength=tcfg.num_classes)
    want[0] = 0
    np.testing.assert_array_equal(res.n_gt, want)
    assert res.summary() in evaluated[-1]
    dets = trainer.last_detections
    assert set(dets) == {"boxes", "scores", "labels"}
    assert dets["boxes"].shape[0] > 0 and np.isfinite(dets["boxes"]).all()
    assert state.step == 4


def test_trainer_without_eval_in_train_keeps_none(tmp_path):
    _, tcfg = cfg_pair()
    trainer = Trainer(tcfg, output_dir=str(tmp_path), device="cpu")
    trainer.train([tiny_scene(0)], trainer.init_state(seed=0), epochs=1)
    assert trainer.last_train_eval is None
    assert trainer.last_detections is None
