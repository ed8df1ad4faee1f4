"""Sparse pooling (detection_3d_tpu_torch/ops/sparse_pool.py) against the
JAX package's (ops/sparse_pool.py), on the CPU.

The books come from both packages' downsample of one table (bit equal,
tests/test_torch_rulebooks.py). Outputs within 1e-6 (the same f32 folds
in the same offset order); the gradient of a weighted sum of each output
against ``jax.grad`` within 1e-6, on tie-free features; and one case
with duplicated features tied for a window's maximum, where both
packages fold the offsets in order and split a tie in halves
(``jnp.maximum`` and ``torch.maximum``), so the gradients agree there
too: among t tied entries the last offset takes 1/2, the one before
1/4, ..., the first 1/2^(t-1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops import sparse as jsparse
from detection_3d_tpu.ops import sparse_conv as jsconv
from detection_3d_tpu.ops import sparse_pool as jpool
from detection_3d_tpu_torch.ops import sparse as tsparse
from detection_3d_tpu_torch.ops import sparse_pool as tpool
from test_torch_common import random_coords, table_pair

SPATIAL = (32, 24, 16)
FNS = ("max_pool", "avg_pool", "unpool")


@pytest.fixture(scope="module")
def books():
    """Tables and books of one downsample, from both packages, and
    tie-free features (a permutation of distinct values)."""
    coords = random_coords(900, SPATIAL, 21)
    rng = np.random.RandomState(4)
    feats = (rng.permutation(coords.shape[0] * 5).reshape(-1, 5)
             .astype(np.float32) / 100.0 - 20.0)
    jt, tt = table_pair(coords, feats, SPATIAL, 1024)
    k = s = (2, 2, 2)
    td, crb, drb = tsparse.downsample_with_rulebooks(tt, k, s, 512)
    jd = jsparse.downsample_table(jt, k, s, 512)
    jcrb = jsparse.conv_rulebook(jd, jt, k, s)
    jdrb = jsconv.deconv_rulebook(jt, jd, k, s)
    np.testing.assert_array_equal(crb.numpy(), np.asarray(jcrb))
    np.testing.assert_array_equal(drb.numpy(), np.asarray(jdrb))
    coarse = rng.randn(512, 5).astype(np.float32)
    return tt, td, crb, drb, coarse


def _args(fn, books, fine_feats):
    """(feats, book, valid) of ``fn`` as numpy arrays."""
    tt, td, crb, drb, coarse = books
    if fn == "unpool":
        return coarse, drb.numpy(), tt.row_valid.numpy()
    return fine_feats, crb.numpy(), td.row_valid.numpy()


def _both(fn, feats, idx, valid, weight):
    """(JAX output, JAX gradient, port output, port gradient) of
    sum(fn(feats) * weight)."""
    jf = getattr(jpool, fn)

    def loss(f):
        return (jf(f, jnp.asarray(idx), jnp.asarray(valid)) * weight).sum()

    j_out = np.asarray(jf(jnp.asarray(feats), jnp.asarray(idx),
                          jnp.asarray(valid)))
    j_grad = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    x = torch.from_numpy(feats.copy()).requires_grad_()
    out = getattr(tpool, fn)(x, torch.from_numpy(idx),
                             torch.from_numpy(valid))
    (out * torch.from_numpy(weight)).sum().backward()
    return j_out, j_grad, out.detach(), x.grad.numpy()


@pytest.mark.parametrize("fn", FNS)
def test_pool_outputs_and_gradients(books, fn):
    tt = books[0]
    feats, idx, valid = _args(fn, books, tt.feats.numpy())
    weight = np.random.RandomState(5).randn(idx.shape[1], 5).astype(
        np.float32)
    j_out, j_grad, t_out, t_grad = _both(fn, feats, idx, valid, weight)
    assert t_out.dtype == torch.float32 and t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-6, atol=1e-6)
    assert np.abs(t_out.numpy()).sum() > 0
    assert not t_out.numpy()[~valid].any()


def test_max_pool_ties_route_the_gradient_alike():
    """A full 4 x 4 x 4 block: each of the 8 windows holds 8 inputs. The
    first window's 8 inputs tie: the gradient splits as JAX's fold
    splits it, 1/2 to the last offset down to 1/128 to the first two."""
    grid = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    coords = np.c_[grid.reshape(-1, 3), np.zeros(64)].astype(np.int32)
    feats = np.random.RandomState(6).permutation(128).reshape(64, 2) \
        .astype(np.float32)
    _, t = table_pair(coords, feats, (4, 4, 4), 64)
    d, crb, _ = tsparse.downsample_with_rulebooks(t, (2, 2, 2), (2, 2, 2),
                                                  8)
    idx = crb.numpy()
    tied = idx[:, 0]
    assert (tied < 64).all()
    feats = t.feats.numpy().copy()
    feats[tied] = 500.0
    weight = np.ones((8, 2), np.float32)
    j_out, j_grad, t_out, t_grad = _both("max_pool", feats, idx,
                                         d.row_valid.numpy(), weight)
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    np.testing.assert_array_equal(t_grad, j_grad)
    np.testing.assert_array_equal(
        t_grad[tied, 0], [2.0 ** -7] + [2.0 ** -(8 - k) for k in range(1, 8)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pools_keep_the_input_dtype(books, dtype):
    tt, td, crb, drb, coarse = books
    dt = getattr(torch, dtype)
    f = tt.feats.to(dt)
    assert tpool.max_pool(f, crb, td.row_valid).dtype == dt
    assert tpool.avg_pool(f, crb, td.row_valid).dtype == dt
    assert tpool.unpool(torch.from_numpy(coarse).to(dt), drb,
                        tt.row_valid).dtype == dt


def test_jax_fixture_values():
    """JAX's own fixture (tests/test_sparse_pool.py): max 5 and 7, mean 3
    and 7, and unpool hands each fine site its parent's mean."""
    coords = np.array([[0, 0, 0, 0], [1, 1, 1, 0], [1, 0, 0, 0],
                       [4, 4, 4, 0]], np.int32)
    feats = np.array([[1.0], [5.0], [3.0], [7.0]], np.float32)
    _, t = table_pair(coords, feats, (8, 8, 8), 9)
    d, crb, drb = tsparse.downsample_with_rulebooks(t, (2, 2, 2), (2, 2, 2),
                                                    8)
    n = int(d.num)
    mx = tpool.max_pool(t.feats, crb, d.row_valid)[:n, 0].tolist()
    avg = tpool.avg_pool(t.feats, crb, d.row_valid)
    assert sorted(mx) == [5.0, 7.0]
    assert sorted(avg[:n, 0].tolist()) == [3.0, 7.0]
    up = tpool.unpool(avg, drb, t.row_valid)
    parent = {tuple(c[:3]): float(avg[i, 0])
              for i, c in enumerate(d.coords[:n].tolist())}
    for i, c in enumerate(t.coords[:int(t.num)].tolist()):
        assert float(up[i, 0]) == parent[(c[0] // 2, c[1] // 2, c[2] // 2)]
