"""The packed serving forms against the JAX package, on the CPU.

make_predict_fn(packed=True / "table" / "pyramid") against the JAX
package's make_predict_fn of the same form, with the same (converted)
weights and the same packed inputs: ``true_num`` equal, and the valid
rows of the (K, 10) output the same set, compared sorted by (label,
score), boxes and scores within 1e-4 (as tests/test_torch_detector_e2e
holds the raw form). The batched and pipelined serving, which need no
JAX, are tests/test_torch_pipelined_inference.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.data import pyramid_packing as jpyr
from detection_3d_tpu.engine.inference import make_predict_fn as j_predict_fn
from detection_3d_tpu.models.detector import SparseRCNN as JRCNN
from detection_3d_tpu_torch.data.packing import pack_scene, pack_table
from detection_3d_tpu_torch.data.pyramid_packing import pack_pyramid
from detection_3d_tpu_torch.engine.inference import (
    make_batch_predict_fn, make_predict_fn, run_inference,
)
from detection_3d_tpu_torch.models.detector import SparseRCNN
from test_torch_common import cfg_pair, scene_tables, tiny_scene, to_numpy_tree

PACKERS = {True: pack_scene, "table": pack_table, "pyramid": pack_pyramid}


def _valid_rows(packed):
    a = np.asarray(packed)
    a = a[a[:, 9] > 0.5]
    return a[np.lexsort((a[:, 7], a[:, 8]))]


@pytest.fixture(scope="module")
def weights():
    """JAX params of the tiny model, and the port's model loaded with
    them (one JAX init compile for the file)."""
    jcfg, tcfg = cfg_pair()
    jt, _ = scene_tables(jcfg, tcfg)
    params = jax.jit(lambda k: JRCNN(jcfg).init(k, jt, is_train=False))(
        jax.random.PRNGKey(0))
    params = to_numpy_tree(params)
    return jcfg, tcfg, params, SparseRCNN(tcfg).load_jax_params(params)


@pytest.mark.parametrize("packed", [True, "table", "pyramid"])
def test_packed_predict_matches_jax(weights, packed):
    jcfg, tcfg, params, model = weights
    scene = tiny_scene(0)
    host = PACKERS[packed](tcfg, scene)
    jhost = jpyr.pack_pyramid(jcfg, scene) if packed == "pyramid" else host
    jout, jtrue = j_predict_fn(jcfg, packed=packed)(
        params, {k: jnp.asarray(v) for k, v in jhost.items()})
    tout, ttrue = make_predict_fn(tcfg, model, device="cpu",
                                  packed=packed)(host)
    assert int(ttrue) == int(jtrue)
    assert tout.shape == (tcfg.roi_detections_per_img, 10)
    want, got = _valid_rows(jout), _valid_rows(tout.numpy())
    assert want.shape[0] > 0 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, 8], want[:, 8])
    np.testing.assert_allclose(got[:, :8], want[:, :8], atol=1e-4, rtol=0)


def test_bad_forms_raise(weights):
    _, tcfg, _, model = weights
    with pytest.raises(ValueError, match="packed"):
        make_predict_fn(tcfg, model, device="cpu", packed="points")
    with pytest.raises(ValueError, match="packed"):
        make_batch_predict_fn(tcfg, model, device="cpu", packed=False)
    with pytest.raises(ValueError, match="pack_mode"):
        run_inference(tcfg, model, [], device="cpu", pipelined=True,
                      pack_mode="points")
    with pytest.raises(ValueError, match="pack_workers"):
        run_inference(tcfg, model, [], device="cpu", pipelined=True,
                      pack_workers=0)


def test_training_forward_on_a_host_pyramid_raises(weights):
    """A host pyramid carries no backward books: a forward with gt and a
    gradient refuses it; without a gradient it serves."""
    from detection_3d_tpu_torch.data.packing import to_device
    from detection_3d_tpu_torch.data.pyramid_packing import unpack_pyramid
    from detection_3d_tpu_torch.models.structures import Boxes3D
    _, tcfg, _, model = weights
    packed = to_device(pack_pyramid(tcfg, tiny_scene(6)), "cpu")
    pyr = unpack_pyramid(tcfg, packed)
    gt = Boxes3D(packed["gt_boxes"], packed["gt_valid"])
    with pytest.raises(NotImplementedError, match="backward books"):
        model(pyr["tables"][0], gt, packed["gt_labels"], pyramid=pyr)
    with torch.no_grad():
        losses = model(pyr["tables"][0], gt, packed["gt_labels"],
                       pyramid=pyr)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
