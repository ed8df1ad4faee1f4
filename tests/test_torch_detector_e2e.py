"""The slice end to end: one synthetic building through the JAX package's
make_predict_fn and through the port's make_predict_fn(device="cpu"),
with the same (converted) weights and compute_dtype float32.

``true_num`` must be equal; the valid rows of the packed (K, 10) output
must be the same set, compared sorted by (label, score), with boxes and
scores within 1e-4. Invalid rows' payload is not compared.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.engine.inference import make_predict_fn as j_predict_fn
from detection_3d_tpu.models.detector import SparseRCNN as JRCNN
from detection_3d_tpu_torch.engine.inference import (
    make_predict_fn, pad_scene, run_inference,
)
from detection_3d_tpu_torch.models.detector import SparseRCNN
from test_torch_common import cfg_pair, scene_tables, tiny_scene, to_numpy_tree


def _valid_rows(packed):
    a = np.asarray(packed)
    a = a[a[:, 9] > 0.5]
    return a[np.lexsort((a[:, 7], a[:, 8]))]


@pytest.fixture(scope="module")
def jax_run():
    """JAX params and packed output for the tiny building (one compile of
    the JAX forward, shared by the tests of this file)."""
    jcfg, tcfg = cfg_pair()
    jt, _ = scene_tables(jcfg, tcfg)
    params = jax.jit(lambda k: JRCNN(jcfg).init(k, jt, is_train=False))(
        jax.random.PRNGKey(0))
    batch = pad_scene(tcfg, tiny_scene())
    out, true_num = j_predict_fn(jcfg)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return tcfg, to_numpy_tree(params), batch, np.asarray(out), int(true_num)


def test_predict_matches_jax(jax_run):
    tcfg, params, batch, jout, jtrue = jax_run
    model = SparseRCNN(tcfg).load_jax_params(params)
    tout, ttrue = make_predict_fn(tcfg, model, device="cpu")(batch)
    assert ttrue.item() == jtrue
    assert tout.shape == jout.shape == (tcfg.roi_detections_per_img, 10)
    want, got = _valid_rows(jout), _valid_rows(tout.numpy())
    assert want.shape[0] > 0
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 8], want[:, 8])
    np.testing.assert_allclose(got[:, :8], want[:, :8], atol=1e-4, rtol=0)


def test_run_inference_answers_every_building(jax_run):
    tcfg, params, _, jout, _ = jax_run
    model = SparseRCNN(tcfg).load_jax_params(params)
    scenes = [tiny_scene(0), tiny_scene(1)]
    preds, result, sec = run_inference(tcfg, model, scenes, device="cpu")
    assert result is None and sec > 0 and len(preds) == 2
    first = preds[0]
    want = _valid_rows(jout)
    assert first["boxes"].shape == (want.shape[0], 7)
    for p in preds:
        assert np.all(np.isfinite(p["boxes"])) and p["true_num"] > 0
    preds2, result, _ = run_inference(tcfg, model, scenes, device="cpu",
                                      evaluate=True)
    for a, b in zip(preds, preds2):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
    labels = np.concatenate([s["gt_labels"] for s in scenes])
    want_gt = np.bincount(labels, minlength=tcfg.num_classes)
    want_gt[0] = 0
    np.testing.assert_array_equal(result.n_gt, want_gt)
    assert result.class_names == tcfg.ordered_class_names()


def test_seeded_init_is_reproducible():
    _, tcfg = cfg_pair()
    a, b = SparseRCNN(tcfg, seed=5), SparseRCNN(tcfg, seed=5)
    c = SparseRCNN(tcfg, seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.conv_in.w"], sc["backbone.conv_in.w"])
    assert float(sa["roi_head.extractor.conv3d_w"].abs().max()) > 0


# ---- the weight bridge from a JAX checkpoint file ---------------------------


def test_jax_checkpoint_file_loads_and_predicts(jax_run, tmp_path):
    """A JAX trainer checkpoint (params, optax state, step) written by the
    JAX Checkpointer loads through ``load_jax_params(path)``, and the
    port's predict then gives the JAX predict's detections."""
    from detection_3d_tpu.engine.solver import make_optimizer
    from detection_3d_tpu.utils.checkpoint import Checkpointer as JCkpt
    tcfg, params, batch, jout, jtrue = jax_run
    jcfg, _ = cfg_pair()
    tx, _ = make_optimizer(jcfg, params, 1)
    path = JCkpt(str(tmp_path)).save(
        "model_final", {"params": params, "opt_state": tx.init(params),
                        "step": jnp.zeros((), jnp.int32)})
    model = SparseRCNN(tcfg).load_jax_params(path)
    tout, ttrue = make_predict_fn(tcfg, model, device="cpu")(batch)
    assert ttrue.item() == jtrue
    want, got = _valid_rows(jout), _valid_rows(tout.numpy())
    assert got.shape == want.shape and want.shape[0] > 0
    np.testing.assert_array_equal(got[:, 8], want[:, 8])
    np.testing.assert_allclose(got[:, :8], want[:, :8], atol=1e-4, rtol=0)


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
        return
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("leaf", ["float32", "bfloat16", "int32", "scalar",
                                  "tuple"])
def test_load_jax_checkpoint_decodes_flax_leaves(leaf, tmp_path):
    """Every leaf kind of a model's ``flax.serialization.to_bytes`` decodes
    to what flax's own reader gives (bfloat16 as exact float32; tuples as
    dicts keyed "0", "1", ...)."""
    from flax import serialization
    from detection_3d_tpu_torch.utils.checkpoint import load_jax_checkpoint
    arr = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    tree = {"float32": {"w": arr},
            "bfloat16": {"w": jnp.asarray(arr, jnp.bfloat16)},
            "int32": {"i": np.arange(6, dtype=np.int32).reshape(2, 3)},
            "scalar": {"s": np.float32(2.5), "n": jnp.zeros((), jnp.int32)},
            "tuple": {"opt": (arr, {"mu": arr * 2}, ())}}[leaf]
    data = serialization.to_bytes(tree)
    path = tmp_path / "x.msgpack"
    path.write_bytes(data)
    _assert_trees_equal(load_jax_checkpoint(str(path)),
                        serialization.msgpack_restore(data))


def test_load_jax_checkpoint_rejects_other_extensions(tmp_path):
    """A leaf that is no flax array or numpy scalar (here a complex
    number, flax's extension 2) raises instead of passing through."""
    from flax import serialization
    from detection_3d_tpu_torch.utils.checkpoint import load_jax_checkpoint
    path = tmp_path / "x.msgpack"
    path.write_bytes(serialization.to_bytes({"z": 1 + 2j}))
    with pytest.raises(ValueError, match="extension 2"):
        load_jax_checkpoint(str(path))
