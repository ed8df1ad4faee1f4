"""Kernel D's entry points against the JAX package, on the CPU (the
plain version), bit exact: ``conv_rulebook_match`` and
``deconv_rulebook_match`` against the JAX kernel in interpret mode and
against JAX's ``conv_rulebook`` / ``deconv_rulebook`` (as
tests/test_pallas_match.py holds the JAX kernel), and against the
scatter-derived books of the port's ``downsample_with_rulebooks``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops import sparse as jsparse
from detection_3d_tpu.ops.pallas import match_kernel as jmatch
from detection_3d_tpu.ops.sparse_conv import deconv_rulebook as j_deconv_rb
from detection_3d_tpu_torch.ops.coords import INVALID, composite_key
from detection_3d_tpu_torch.ops.multi_match import (
    conv_rulebook_match, deconv_rulebook_match, multi_match,
    multi_match_plain, sorted_multi_match)
from detection_3d_tpu_torch.ops.sparse import downsample_with_rulebooks
from test_torch_common import random_coords, table_pair

SPATIAL = (64, 48, 32)
K2 = (2, 2, 2)


def _pair(n, cap, seed, spatial=SPATIAL):
    coords = random_coords(n, spatial, seed)
    feats = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return table_pair(coords, feats, spatial, cap)


@pytest.fixture(scope="module", params=[(2500, 4096, 7), (900, 4096, 2),
                                        (3000, 4096, 9)])
def pyramid_pair(request):
    """Fine tables of both packages, the port's coarse table with its
    scatter books, and the JAX coarse table."""
    n, cap, seed = request.param
    jt, tt = _pair(n, cap, seed)
    coarse, crb, drb = downsample_with_rulebooks(tt, K2, K2, 2048)
    jcoarse = jsparse.downsample_table(jt, K2, K2, 2048)
    np.testing.assert_array_equal(coarse.coords.numpy(),
                                  np.asarray(jcoarse.coords))
    return jt, tt, jcoarse, coarse, crb, drb


def test_conv_rulebook_match_bit_exact(pyramid_pair):
    jt, tt, jcoarse, coarse, crb, _ = pyramid_pair
    got = conv_rulebook_match(coarse, tt, K2, K2)
    assert got.dtype == torch.int32 and got.shape == (8, coarse.capacity)
    want = np.asarray(jsparse.conv_rulebook(jcoarse, jt, K2, K2))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), crb.numpy())


def test_deconv_rulebook_match_bit_exact(pyramid_pair):
    jt, tt, jcoarse, coarse, _, drb = pyramid_pair
    got = deconv_rulebook_match(tt, coarse, K2, K2)
    assert got.shape == (8, tt.capacity)
    want = np.asarray(j_deconv_rb(jt, jcoarse, K2, K2))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), drb.numpy())


@pytest.mark.parametrize("which", ["conv", "deconv"])
def test_matches_jax_kernel_in_interpret_mode(which):
    jt, tt = _pair(2500, 4096, 8)
    coarse, _, _ = downsample_with_rulebooks(tt, K2, K2, 2048)
    jcoarse = jsparse.downsample_table(jt, K2, K2, 2048)
    if which == "conv":
        want = jmatch.conv_rulebook_match(jcoarse, jt, K2, K2,
                                          interpret=True)
        got = conv_rulebook_match(coarse, tt, K2, K2)
    else:
        want = jmatch.deconv_rulebook_match(jt, jcoarse, K2, K2,
                                            interpret=True)
        got = deconv_rulebook_match(tt, coarse, K2, K2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sorted_multi_match_contract():
    """Found keys give their row, absent or invalid ones V; the queries
    need not be sorted."""
    _, tt = _pair(500, 1024, 3)
    v, num = tt.capacity, int(tt.num)
    rng = np.random.RandomState(0)
    rows = torch.from_numpy(rng.permutation(num)[:200])
    qhi, qlo = tt.hi[rows].clone(), tt.lo[rows].clone()
    qhi[::5] += 100000                      # keys no table row holds
    qvalid = torch.ones(200, dtype=torch.bool)
    qvalid[1::7] = False
    got = sorted_multi_match(qhi[None], qlo[None], qvalid[None], tt)[0]
    want = torch.where(qvalid, rows.to(torch.int32), v)
    want[::5] = v
    assert torch.equal(got, want)


def test_multi_match_plain_edges():
    keys = composite_key(torch.tensor([0, 0, 3, INVALID], dtype=torch.int32),
                         torch.tensor([1, 5, 2, INVALID], dtype=torch.int32))
    q = composite_key(torch.tensor([0, 3, 0, INVALID, 9], dtype=torch.int32),
                      torch.tensor([5, 2, 2, INVALID, 0], dtype=torch.int32))
    want = torch.tensor([1, 2, 4, 4, 4], dtype=torch.int32)
    assert torch.equal(multi_match_plain(keys, q), want)
    assert torch.equal(multi_match(keys, q), want)
