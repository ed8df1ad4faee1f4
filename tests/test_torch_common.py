"""Shared fixtures of the PyTorch-port parity tests, and the tests of the
port's config copy and its Flax-to-torch weight converter.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU (tests/conftest.py) and the port runs its plain PyTorch
versions of the kernels on the CPU. The kernels themselves are tested
on the card by tests/test_torch_kernels_cuda.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.config import defaults as jdefaults
from detection_3d_tpu.ops import sparse as jsparse
from detection_3d_tpu_torch.config import defaults as tdefaults
from detection_3d_tpu_torch.ops import sparse as tsparse
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from torch_match_cases import random_coords  # noqa: F401 (shared helper)

torch.set_num_threads(1)    # xdist workers must not oversubscribe the CPU

CLASSES4 = ("background", "wall", "door", "window")


def tiny_cfg(mod, **kw):
    """tests/test_detector_e2e.py:tiny_cfg with float32 compute, built
    from either package's config module ``mod``."""
    base = dict(
        classes=CLASSES4,
        compute_dtype="float32",
        sparse3d=mod.Sparse3DConfig(
            voxel_scale=20, voxel_full_scale=(256, 256, 64),
            nplanes_front=(8, 16, 16, 32, 32),
            kernels=((2, 2, 2),) * 4, strides=((2, 2, 2),) * 4,
            nplane_map=16),
        rpn=mod.RPNConfig(
            rpn_scales_from_top=(2, 1), rpn_3d_2d_selector=(0, 1, 2),
            anchor_sizes_3d=((0.2, 0.5, 3), (0.4, 1.5, 3), (0.6, 2.5, 3)),
            use_yaws=(1, 1, 1),
            fpn_pre_nms_top_n_train=256, fpn_pre_nms_top_n_test=256,
            fpn_post_nms_top_n_train=64, fpn_post_nms_top_n_test=64,
            batch_size_per_image=64),
        roi=mod.ROIConfig(
            pooler_scales_from_top=(2, 1), batch_size_per_image=64,
            detections_per_img=32, mlp_head_dim=32,
            pooler_resolution=(6, 8, 4)),
        backbone_out_channels=16,
        caps=mod.CapacityConfig(max_points=8192,
                                voxel_caps=(4096, 2048, 1024, 512, 256),
                                max_gt=16),
    )
    base.update(kw)
    return mod.Config(**base)


def cfg_pair(**kw):
    """(JAX config, port config) with identical values."""
    return tiny_cfg(jdefaults, **kw), tiny_cfg(tdefaults, **kw)


def table_pair(coords, feats, spatial, cap, batch=1, valid=None):
    """The same voxel table built by both packages' input layers."""
    n = coords.shape[0]
    valid = np.ones((n,), bool) if valid is None else valid
    jt = jsparse.build_sparse_tensor(jnp.asarray(coords), jnp.asarray(feats),
                                     jnp.asarray(valid), spatial, batch, cap)
    tt = tsparse.build_sparse_tensor(torch.from_numpy(coords),
                                     torch.from_numpy(feats),
                                     torch.from_numpy(valid), spatial, batch,
                                     cap)
    return jt, tt


def assert_tables_equal(jt, tt):
    """Integer fields bit exact, features within f32 rounding."""
    np.testing.assert_array_equal(tt.coords.numpy(), np.asarray(jt.coords))
    np.testing.assert_array_equal(tt.hi.numpy(), np.asarray(jt.hi))
    np.testing.assert_array_equal(tt.lo.numpy(), np.asarray(jt.lo))
    assert int(tt.num) == int(jt.num)
    assert int(tt.true_num) == int(jt.true_num)
    assert tt.spatial_size == jt.spatial_size
    np.testing.assert_allclose(tt.feats.numpy(), np.asarray(jt.feats),
                               rtol=1e-6, atol=1e-6)


def tiny_scene(seed=0):
    """One small synthetic building (the port's copy of the generator)."""
    from detection_3d_tpu_torch.data.synthetic import synthetic_building
    return synthetic_building(seed=seed, num_points=6000, room=6.0,
                              classes=CLASSES4, voxel_scale=20)


def scene_tables(jcfg, tcfg, scene=None):
    """The scale-0 voxel table of one padded building, from both
    packages' voxelize_points."""
    from detection_3d_tpu.models.detector import voxelize_points as jvox
    from detection_3d_tpu_torch.engine.inference import pad_scene
    from detection_3d_tpu_torch.models.detector import voxelize_points
    batch = pad_scene(tcfg, tiny_scene() if scene is None else scene)
    keys = ("points", "feats", "points_valid")
    jt = jvox(jcfg, *(jnp.asarray(batch[k]) for k in keys))
    tt = voxelize_points(tcfg, *(torch.from_numpy(batch[k]) for k in keys))
    return jt, tt


def assert_same(got, want, path="out"):
    """Equal values, dtypes and shapes through nested dicts, lists and
    tuples of numpy arrays and scalars (the numpy copies' outputs)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and (got == want or (
            got != got and want != want)), (path, got, want)


def to_numpy_tree(tree):
    """A JAX parameter tree as nested dicts of writable numpy arrays."""
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


# ---- tests of the config copy and the converter ---------------------------


@pytest.mark.parametrize("build", ["default", "tiny"])
def test_config_copy_matches_jax(build):
    if build == "default":
        jc, tc = jdefaults.Config(), tdefaults.Config()
    else:
        jc, tc = cfg_pair()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jc.validate()
    tc.validate()
    for prop in ("in_channels", "num_classes", "group_num",
                 "rpn_pre_nms_top_n_test", "rpn_post_nms_top_n_test",
                 "roi_detections_per_img"):
        assert getattr(jc, prop) == getattr(tc, prop), prop
    for fn in ("anchor_strides", "rpn_map_sizes", "roi_spatial_scales",
               "ordered_class_names"):
        assert getattr(jc, fn)() == getattr(tc, fn)(), fn
    assert jc.caps.scale_caps(5, 4096) == tc.caps.scale_caps(5, 4096)


def test_full_scale_config_is_the_bench_config():
    import bench
    assert dataclasses.asdict(bench.full_scale_config()) == \
        dataclasses.asdict(tdefaults.full_scale_config())


def test_config_rejects_repeated_rpn_map():
    with pytest.raises(ValueError):
        tiny_cfg(tdefaults, rpn=tdefaults.RPNConfig(
            rpn_scales_from_top=(2, 1), rpn_3d_2d_selector=(0, 0, 2),
            anchor_sizes_3d=((0.2, 0.5, 3),) * 3, use_yaws=(1, 1, 1))
        ).validate()


def test_synthetic_copy_matches_jax():
    from detection_3d_tpu.data import synthetic as jsyn
    from detection_3d_tpu_torch.data import synthetic as tsyn
    pairs = [(jsyn.synthetic_building(seed=3, num_points=2000),
              tsyn.synthetic_building(seed=3, num_points=2000)),
             (jsyn.synthetic_multiroom(seed=1, num_points=4000,
                                       rooms_xy=(2, 2)),
              tsyn.synthetic_multiroom(seed=1, num_points=4000,
                                       rooms_xy=(2, 2)))]
    for a, b in pairs:
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_convert_jax_params_names_and_strictness():
    params = {"params": {"a": {"w": np.ones((2, 3), np.float32)},
                         "b": np.zeros((4,), np.float32)}}
    out = convert_jax_params(params)
    assert set(out) == {"a.w", "b"}
    assert out["a.w"].shape == (2, 3) and out["a.w"].dtype == torch.float32
    with pytest.raises(ValueError):
        convert_jax_params({"a.b": np.ones(1)})


def test_converted_tree_loads_strictly():
    """Every Flax leaf of the JAX model lands on exactly one port
    parameter of the same shape, and nothing is left over."""
    from detection_3d_tpu.models.detector import (
        SparseRCNN as JRCNN, voxelize_points as jvox)
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    jc, tc = cfg_pair()
    rng = np.random.RandomState(0)
    n = 500
    pts = rng.uniform(0, 60, (n, 3)).astype(np.float32)
    table = jvox(jc, jnp.asarray(pts),
                 jnp.asarray(rng.randn(n, 9).astype(np.float32)),
                 jnp.ones((n,), bool))
    params = jax.eval_shape(
        lambda k: JRCNN(jc).init(k, table, is_train=False),
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), params)
    model = SparseRCNN(tc)
    model.load_jax_params(tree)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert n_leaves == len(model.state_dict())
    # one extra leaf must be refused
    tree["params"]["backbone"]["extra"] = {"w": np.zeros((1,), np.float32)}
    with pytest.raises(RuntimeError):
        model.load_jax_params(tree)
