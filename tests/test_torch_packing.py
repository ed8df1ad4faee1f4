"""The port's host packers (data/packing.py) against the JAX package's.

pack_scene and pack_table must give JAX's arrays bit for bit (dtype
included), with and without the strided capacity-overflow keep; the
device unpacks must give JAX's coords and keys bit for bit and its
features within 1e-6; and a table unpacked from pack_table must equal
the port's voxelize_points on the raw batch in coords, keys, num and
true_num (features within the quantization steps).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.data import packing as jpacking
from detection_3d_tpu_torch.data import packing as tpacking
from detection_3d_tpu_torch.engine.inference import pad_scene
from detection_3d_tpu_torch.models.detector import voxelize_points
from test_torch_common import cfg_pair, tiny_scene

# scale-0 capacities: none of a tiny building's ~5200 voxels dropped,
# every 2nd kept, every 6th kept
CAPS0 = {"fits": 8192, "overflow": 4096, "overflow6": 1024}


def _cfgs(case):
    jc, tc = cfg_pair()
    return tuple(dataclasses.replace(
        c, caps=dataclasses.replace(
            c.caps, voxel_caps=(CAPS0[case],) + c.caps.voxel_caps[1:]))
        for c in (jc, tc))


def _assert_same_arrays(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("seed", [0, 4])
def test_pack_scene_matches_jax(seed):
    jc, tc = cfg_pair()
    scene = tiny_scene(seed)
    _assert_same_arrays(tpacking.pack_scene(tc, scene),
                        jpacking.pack_scene(jc, scene))


@pytest.mark.parametrize("case", sorted(CAPS0))
def test_pack_table_matches_jax(case):
    jc, tc = _cfgs(case)
    scene = tiny_scene(1)
    got = tpacking.pack_table(tc, scene)
    _assert_same_arrays(got, jpacking.pack_table(jc, scene))
    assert (int(got["true_num"]) > CAPS0[case]) == (case != "fits")


def test_packers_reject_other_layouts():
    _, tc = cfg_pair()
    scene = tiny_scene(0)
    for fn in (tpacking.pack_scene, tpacking.pack_table):
        with pytest.raises(ValueError):
            fn(tc.replace(elements=("xyz",)), scene)


def _j(packed):
    return {k: jnp.asarray(v) for k, v in packed.items()}


@pytest.mark.parametrize("case", sorted(CAPS0))
def test_unpack_table_matches_jax(case):
    jc, tc = _cfgs(case)
    packed = tpacking.pack_table(tc, tiny_scene(2))
    got = tpacking.unpack_table(tc, tpacking.to_device(packed, "cpu"))
    want = jpacking.unpack_table(jc, _j(packed))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))
    assert int(got.num) == int(want.num)
    assert int(got.true_num) == int(want.true_num)
    assert got.spatial_size == want.spatial_size
    assert got.feats.dtype == torch.float32
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=0, atol=1e-6)


def test_unpack_batch_matches_jax():
    jc, tc = cfg_pair()
    packed = tpacking.pack_scene(tc, tiny_scene(3))
    got = tpacking.unpack_batch(tc, tpacking.to_device(packed, "cpu"))
    want = jpacking.unpack_batch(jc, _j(packed))
    assert set(got) == set(want)
    for k in ("points_valid", "gt_boxes", "gt_labels", "gt_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["points"].numpy(),
                                  np.asarray(want["points"]))
    np.testing.assert_allclose(got["feats"].numpy(), np.asarray(want["feats"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CAPS0))
def test_unpack_table_matches_voxelize_points(case):
    """The host input layer equals the port's device input layer on the
    raw batch: coords, keys, num and true_num bit exact, features within
    the quantization steps (1/512 voxel, 1/510, 1/254)."""
    _, tc = _cfgs(case)
    scene = tiny_scene(5)
    raw = pad_scene(tc, scene)
    want = voxelize_points(tc, *(torch.from_numpy(raw[k]) for k in
                                 ("points", "feats", "points_valid")))
    got = tpacking.unpack_table(
        tc, tpacking.to_device(tpacking.pack_table(tc, scene), "cpu"))
    for f in ("coords", "hi", "lo", "keys"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.num) == int(want.num)
    assert int(got.true_num) == int(want.true_num)
    rv = want.row_valid
    d = (got.feats - want.feats)[rv].abs()
    scale = tc.sparse3d.voxel_scale
    assert float(d[:, :3].max()) <= 1.0 / 256 / scale + 1e-5
    assert float(d[:, 3:6].max()) <= 1.0 / 255 + 1e-6
    assert float(d[:, 6:9].max()) <= 1.0 / 127 + 1e-6
    assert not bool(got.feats[~rv].any())


def test_unpack_batch_voxelizes_bit_exact():
    """pack_scene's 1/8-voxel fixed point voxelizes to the same table as
    the f32 points: coords, keys, num, true_num."""
    _, tc = cfg_pair()
    scene = tiny_scene(6)
    raw = pad_scene(tc, scene)
    keys = ("points", "feats", "points_valid")
    want = voxelize_points(tc, *(torch.from_numpy(raw[k]) for k in keys))
    b = tpacking.unpack_batch(
        tc, tpacking.to_device(tpacking.pack_scene(tc, scene), "cpu"))
    got = voxelize_points(tc, *(b[k] for k in keys))
    for f in ("coords", "hi", "lo", "keys"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.num) == int(want.num)
    assert int(got.true_num) == int(want.true_num)
