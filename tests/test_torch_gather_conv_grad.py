"""The gather-conv gradient of the port against JAX's VJP, on the CPU.

The port's :class:`GatherConv` backward (here its plain version, the one
the CPU takes) must equal ``jax.vjp`` of the JAX package's
``ops/sparse_conv.gather_conv``, which is what the TPU kernel's custom
VJP differentiates, on every kind of book ``build_pyramid`` makes:
submanifold, strided, deconv and BEV. Tolerance 1e-5 absolute (f32 sums
in another order). ``torch.autograd.gradcheck`` then holds the Function
to finite differences in f64 on a small book.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops.sparse_conv import gather_conv as j_gather_conv
from detection_3d_tpu_torch.models.backbone import build_pyramid
from detection_3d_tpu_torch.ops.sparse_conv import (
    GatherConv, gather_conv_backward, sparse_conv)
from test_torch_common import cfg_pair, scene_tables


@pytest.fixture(scope="module")
def books():
    """(name, V_in, idx, out_valid) of each book kind of the tiny
    building's pyramid."""
    jcfg, tcfg = cfg_pair()
    _, t0 = scene_tables(jcfg, tcfg)
    pyr = build_pyramid(t0, tcfg)
    tables = pyr["tables"]
    n = len(tables)
    bev_t, bev_rb = pyr["bev"][0]
    src3d = tables[n - 1 - tcfg.rpn.rpn_scales_from_top[0]]
    return {
        "subm": (tables[0].capacity, pyr["subm_idx"][0], tables[0].row_valid),
        "subm_s2": (tables[2].capacity, pyr["subm_idx"][2],
                    tables[2].row_valid),
        "strided": (tables[0].capacity, pyr["down_rb"][0],
                    tables[1].row_valid),
        # up_rb is in decoder order: its last book maps scale 1 onto 0
        "deconv": (tables[1].capacity, pyr["up_rb"][-1],
                   tables[0].row_valid),
        "bev": (src3d.capacity, bev_rb, bev_t.row_valid),
    }


def _inputs(v_in, k, cin, cout, v_out, seed):
    rng = np.random.RandomState(seed)
    feats = rng.normal(0, 1, (v_in, cin)).astype(np.float32)
    w = (rng.normal(0, 1, (k, cin, cout)) / np.sqrt(k * cin)).astype(
        np.float32)
    # upstream gradients of a mean-reduced loss are small: dW sums
    # thousands of rows, and at this scale it stays O(1)
    g = (0.05 * rng.normal(0, 1, (v_out, cout))).astype(np.float32)
    return feats, w, g


@pytest.mark.parametrize("kind", ["subm", "subm_s2", "strided", "deconv",
                                  "bev"])
def test_backward_matches_jax_vjp(books, kind):
    v_in, idx, valid = books[kind]
    k, v_out = idx.shape
    feats, w, g = _inputs(v_in, k, 8, 12, v_out, seed=k + v_in)
    assert int((idx < v_in).sum()) > 0, "the book holds real entries"

    _, vjp = jax.vjp(lambda f, ww: j_gather_conv(
        f, jnp.asarray(idx.numpy()), ww, jnp.asarray(valid.numpy())),
        jnp.asarray(feats), jnp.asarray(w))
    want_f, want_w = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    f_t = torch.from_numpy(feats).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    out = sparse_conv(f_t, idx, w_t, valid)
    assert type(out.grad_fn).__name__ == "GatherConvBackward"
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(f_t.grad.numpy(), want_f, atol=1e-5, rtol=0)
    np.testing.assert_allclose(w_t.grad.numpy(), want_w, atol=1e-5, rtol=0)
    # the plain backward on its own, and the mask: invalid outputs pass
    # no gradient
    d_f, d_w = gather_conv_backward(torch.from_numpy(feats), idx,
                                    torch.from_numpy(w), valid,
                                    torch.from_numpy(g))
    assert d_f.dtype == d_w.dtype == torch.float32
    np.testing.assert_allclose(d_w.numpy(), want_w, atol=1e-5, rtol=0)
    g_masked = torch.from_numpy(g) * valid[:, None]
    d_f2, d_w2 = gather_conv_backward(torch.from_numpy(feats), idx,
                                      torch.from_numpy(w), valid, g_masked)
    assert torch.equal(d_f2, d_f) and torch.equal(d_w2, d_w)


def test_backward_returns_input_dtypes_and_skips_index_grads(books):
    v_in, idx, valid = books["subm"]
    feats, w, g = _inputs(v_in, idx.shape[0], 4, 4, idx.shape[1], seed=1)
    d_f, d_w = gather_conv_backward(
        torch.from_numpy(feats).to(torch.bfloat16), idx,
        torch.from_numpy(w).to(torch.bfloat16), valid,
        torch.from_numpy(g).to(torch.bfloat16))
    assert d_f.dtype == d_w.dtype == torch.bfloat16
    # no gradient is asked of the features: only dW is formed
    w_t = torch.from_numpy(w).requires_grad_()
    out = sparse_conv(torch.from_numpy(feats), idx, w_t, valid)
    out.sum().backward()
    assert w_t.grad is not None and w_t.grad.shape == w.shape


def test_no_grad_forward_skips_the_function(books):
    v_in, idx, valid = books["strided"]
    feats, w, _ = _inputs(v_in, idx.shape[0], 4, 4, idx.shape[1], seed=2)
    with torch.no_grad():
        out = sparse_conv(torch.from_numpy(feats),
                          idx, torch.from_numpy(w).requires_grad_(), valid)
    assert out.grad_fn is None


def test_gradcheck_f64():
    """Finite differences in f64 on a 3-offset book with pad entries,
    a repeated input row across offsets and an invalid output row."""
    idx = torch.tensor([[0, 2, 5, 5], [1, 5, 3, 0], [4, 2, 5, 1]],
                       dtype=torch.int32)
    valid = torch.tensor([True, True, False, True])
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn((5, 3), dtype=torch.float64, generator=gen,
                        requires_grad=True)
    w = torch.randn((3, 3, 2), dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda f, ww: GatherConv.apply(f, idx, ww, valid), (feats, w))
