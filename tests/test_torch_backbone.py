"""The backbone (models/backbone.SparseFPN) and the ROI pooler against the
JAX package with the same converted weights. rtol 1e-4: XLA and torch
sum the K gathered products and the BN statistics in different orders,
and each of the network's ~20 layers renormalises what it is given.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.models.backbone import SparseFPN as JFPN
from detection_3d_tpu.models.backbone import build_pyramid as j_pyramid
from detection_3d_tpu.models.roi_head import pool_rois as j_pool
from detection_3d_tpu.models.structures import Boxes3D as JBoxes
from detection_3d_tpu_torch.models.backbone import SparseFPN, build_pyramid
from detection_3d_tpu_torch.models.roi_head import pool_rois
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.ops.sparse import SparseTensor
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from test_torch_common import cfg_pair, scene_tables, to_numpy_tree


def _maps_close(jmaps, tmaps):
    assert len(jmaps) == len(tmaps)
    for jm, tm in zip(jmaps, tmaps):
        np.testing.assert_array_equal(tm.coords.numpy(), np.asarray(jm.coords))
        want = np.asarray(jm.feats)
        got = tm.feats.numpy()
        assert got.dtype == want.dtype
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("residual", [True, False])
def test_sparse_fpn_maps_match_jax(residual):
    jcfg, tcfg = cfg_pair()
    if not residual:      # the VGG-style encoder: BN + conv per block
        jcfg = jcfg.replace(sparse3d=dataclasses.replace(
            jcfg.sparse3d, residual_block=False))
        tcfg = tcfg.replace(sparse3d=dataclasses.replace(
            tcfg.sparse3d, residual_block=False))
    jt, tt = scene_tables(jcfg, tcfg)
    jpyr = j_pyramid(jt, jcfg)
    jmodel = JFPN(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jt, jpyr)
    jrpn, jroi = jax.jit(jmodel.apply)(params, jt, jpyr)

    model = SparseFPN(tcfg)
    model.load_state_dict(convert_jax_params(to_numpy_tree(params)),
                          strict=True)
    with torch.inference_mode():
        trpn, troi = model(tt, build_pyramid(tt, tcfg))
    _maps_close(jrpn, trpn)
    _maps_close(jroi, troi)


def test_pool_rois_matches_jax():
    """Merged multi-level rotated ROI align on the same feature maps."""
    jcfg, tcfg = cfg_pair()
    jt, tt = scene_tables(jcfg, tcfg)
    jpyr = j_pyramid(jt, jcfg)
    rng = np.random.RandomState(0)
    jmaps, tmaps = [], []
    for i_from_top in jcfg.roi.pooler_scales_from_top:
        s = jcfg.sparse3d.num_scales - 1 - i_from_top
        t = jpyr["tables"][s]
        feats = rng.randn(t.capacity, 16).astype(np.float32) * \
            np.asarray(t.row_valid)[:, None]
        jmaps.append(t.with_feats(jnp.asarray(feats)))
        tmaps.append(SparseTensor(
            torch.from_numpy(np.array(t.coords)), torch.from_numpy(feats),
            torch.from_numpy(np.array(t.hi)), torch.from_numpy(np.array(t.lo)),
            torch.tensor(int(t.num), dtype=torch.int32), t.spatial_size, 1))
    n = 60
    boxes = np.c_[rng.uniform(0, 6, (n, 2)), rng.uniform(0, 2, (n, 1)),
                  rng.uniform(0.05, 3.0, (n, 3)),
                  rng.uniform(-1.6, 1.6, (n, 1))].astype(np.float32)
    valid = rng.rand(n) > 0.2
    want = np.asarray(j_pool(jcfg, jmaps, JBoxes(jnp.asarray(boxes),
                                                 jnp.asarray(valid))))
    got = pool_rois(tcfg, tmaps, Boxes3D(torch.from_numpy(boxes),
                                         torch.from_numpy(valid))).numpy()
    assert got.shape == want.shape == (n, 6, 8, 4, 16)
    assert np.abs(want).max() > 0.1          # rois really hit active voxels
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
