"""Kernel A's module (ops/sparse_conv.py, ops/norm.py): the port's plain
gather-conv against JAX's gather_conv and against the Pallas kernel in
interpret mode, plus NiN and masked BN. Tolerance: rtol/atol 1e-5 in f32
(both sides sum K products of f32 rows in f32; only the order differs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops import sparse as jsparse
from detection_3d_tpu.ops.norm import batch_norm_leaky_relu as j_bn
from detection_3d_tpu.ops.pallas.gather_conv_kernel import (
    windowed_gather_conv_interpret,
)
from detection_3d_tpu.ops.sparse_conv import gather_conv as j_gather_conv
from detection_3d_tpu.ops.sparse_conv import nin_conv as j_nin
from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops import sparse as tsparse
from detection_3d_tpu_torch.ops.norm import batch_norm_leaky_relu as t_bn
from detection_3d_tpu_torch.ops.sparse_conv import (
    gather_conv, nin_conv, sparse_conv,
)
from test_torch_common import random_coords, table_pair  # noqa: F401

SPATIAL = (32, 24, 16)


def _tables(seed=0, n=1500, cap=2048):
    coords = random_coords(n, SPATIAL, seed)
    feats = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return table_pair(coords, feats, SPATIAL, cap)


def _rulebook(kind, jt):
    """(K, V_out) int32 rulebook and (V_out,) out_valid of one kind."""
    if kind == "subm":
        idx = jsparse.neighbor_indices(jt, jsparse.submanifold_offsets(
            (3, 3, 3)))
        return np.array(idx), np.array(jt.row_valid)
    if kind == "down":
        out, crb, _ = jsparse.downsample_with_rulebooks(jt, (2, 2, 2),
                                                        (2, 2, 2), 1024)
        return np.array(crb), np.array(out.row_valid)
    from detection_3d_tpu.models.backbone import bev_with_rulebook
    bev, rb = bev_with_rulebook(jt, jt.capacity)
    return np.array(rb), np.array(bev.row_valid)


@pytest.mark.parametrize("kind", ["subm", "down", "bev"])
@pytest.mark.parametrize("cin", [9, 16, 32])
def test_plain_gather_conv_matches_jax(kind, cin):
    jt, _ = _tables()
    idx, out_valid = _rulebook(kind, jt)
    k = idx.shape[0]
    rng = np.random.RandomState(cin)
    feats = rng.randn(jt.capacity, cin).astype(np.float32)
    feats[int(jt.num):] = 0.0
    w = (rng.randn(k, cin, 16) * 0.2).astype(np.float32)
    # pad rows present: the rulebook holds V_in entries and invalid rows
    assert (idx == jt.capacity).any() and not out_valid.all()
    want = np.asarray(j_gather_conv(jnp.asarray(feats), jnp.asarray(idx),
                                    jnp.asarray(w), jnp.asarray(out_valid)))
    got = gather_conv(torch.from_numpy(feats), torch.from_numpy(idx),
                      torch.from_numpy(w), torch.from_numpy(out_valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[~out_valid] == 0)


@pytest.mark.parametrize("cin", [9, 16, 32])
def test_plain_gather_conv_matches_pallas_interpret(cin):
    jt, _ = _tables(seed=3, n=2500, cap=4096)
    idx, out_valid = _rulebook("subm", jt)
    rng = np.random.RandomState(10 + cin)
    feats = rng.randn(jt.capacity, cin).astype(np.float32)
    w = (rng.randn(27, cin, 16) * 0.2).astype(np.float32)
    f, wj = jnp.asarray(feats), jnp.asarray(w)
    if cin == 9:   # the Pallas kernel takes Cin padded to a lane divisor
        f = jnp.pad(f, ((0, 0), (0, 7)))
        wj = jnp.pad(wj, ((0, 0), (0, 7), (0, 0)))
    want = np.asarray(windowed_gather_conv_interpret(
        f, jnp.asarray(idx), wj, jnp.asarray(out_valid)))
    got = gather_conv(torch.from_numpy(feats), torch.from_numpy(idx),
                      torch.from_numpy(w), torch.from_numpy(out_valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_sparse_conv_on_cpu_is_the_plain_version():
    _, tt = _tables()
    idx = tsparse.neighbor_match_3x3x3(tt)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(tt.capacity, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(27, 8, 8).astype(np.float32))
    before = dict(cuda_lib.launches)
    got = sparse_conv(feats, idx, w, tt.row_valid)
    torch.testing.assert_close(got, gather_conv(feats, idx, w, tt.row_valid),
                               rtol=0, atol=0)
    assert cuda_lib.launches == before    # no kernel launched on the CPU


def test_nin_and_bn_match_jax():
    rng = np.random.RandomState(4)
    feats = rng.randn(300, 12).astype(np.float32)
    valid = rng.rand(300) > 0.3
    w = rng.randn(12, 20).astype(np.float32)
    want = np.asarray(j_nin(jnp.asarray(feats), jnp.asarray(w),
                            jnp.asarray(valid)))
    got = nin_conv(torch.from_numpy(feats), torch.from_numpy(w),
                   torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    scale = rng.rand(12).astype(np.float32) + 0.5
    bias = rng.randn(12).astype(np.float32)
    for leak in (0.0, 0.33):
        want = np.asarray(j_bn(jnp.asarray(feats), jnp.asarray(valid),
                               jnp.asarray(scale), jnp.asarray(bias),
                               leakiness=leak))
        got = t_bn(torch.from_numpy(feats), torch.from_numpy(valid),
                   torch.from_numpy(scale), torch.from_numpy(bias),
                   leakiness=leak)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert np.all(got.numpy()[~valid] == 0)
