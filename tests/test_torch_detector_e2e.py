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
    with pytest.raises(NotImplementedError):
        run_inference(tcfg, model, scenes, device="cpu", evaluate=True)


def test_seeded_init_is_reproducible():
    _, tcfg = cfg_pair()
    a, b = SparseRCNN(tcfg, seed=5), SparseRCNN(tcfg, seed=5)
    c = SparseRCNN(tcfg, seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.conv_in.w"], sc["backbone.conv_in.w"])
    assert float(sa["roi_head.extractor.conv3d_w"].abs().max()) > 0
