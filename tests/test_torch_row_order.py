"""Kernel A's row order (ops/sparse_conv.rulebook_row_order), on the CPU.

Every rulebook of the tiny building's pyramid gets a RowOrder: a
permutation of its output rows sorted (stably) by the mask of offsets at
which each row has a real entry. The plain gather-conv with an order
must give what it gives without one, and what the JAX package's
gather_conv and the Pallas kernel in interpret mode give on the same
numpy inputs (1e-5: f32 sums in another order). The backbone and the
training step run with the orders wired in; tests/test_torch_backbone.py
and tests/test_torch_train_step.py hold them against JAX.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops.pallas.gather_conv_kernel import (
    windowed_gather_conv_interpret,
)
from detection_3d_tpu.ops.sparse_conv import gather_conv as j_gather_conv
from detection_3d_tpu_torch.models.backbone import SparseFPN, build_pyramid
from detection_3d_tpu_torch.ops import sparse_conv as tsc
from detection_3d_tpu_torch.ops.sparse_conv import (
    Book, RowOrder, gather_conv, row_masks, rulebook_row_order, sparse_conv,
)
from test_torch_common import cfg_pair, scene_tables

KINDS = ["subm", "subm_s2", "down", "up", "bev"]


@pytest.fixture(scope="module")
def pyramid():
    jcfg, tcfg = cfg_pair()
    _, t0 = scene_tables(jcfg, tcfg)
    return tcfg, t0, build_pyramid(t0, tcfg)


def _book(pyramid, kind):
    """(V_in, idx, out_valid, the pyramid's RowOrder) of one book kind."""
    tcfg, _, pyr = pyramid
    tables = pyr["tables"]
    cap = [t.capacity for t in tables]
    valid = [t.row_valid for t in tables]
    if kind == "subm":
        return cap[0], pyr["subm"][0].idx, valid[0], pyr["subm"][0].order
    if kind == "subm_s2":
        return cap[2], pyr["subm"][2].idx, valid[2], pyr["subm"][2].order
    if kind == "down":
        return cap[0], pyr["down"][0].idx, valid[1], pyr["down"][0].order
    if kind == "up":     # level order: up[0] maps scale 1 onto 0
        return cap[1], pyr["up"][0].idx, valid[0], pyr["up"][0].order
    n = len(tables)
    bev_t, book = pyr["bev"][0]
    src = tables[n - 1 - tcfg.rpn.rpn_scales_from_top[0]]
    return src.capacity, book.idx, bev_t.row_valid, book.order


@pytest.mark.parametrize("kind", KINDS)
def test_row_order_is_a_stable_permutation_by_mask(pyramid, kind):
    v_in, idx, valid, order = _book(pyramid, kind)
    v_out = idx.shape[1]
    perm = order.perm.to(torch.int64)
    assert order.perm.dtype == torch.int32
    assert order.masks.dtype == torch.int64
    assert torch.equal(torch.sort(perm).values, torch.arange(v_out))
    # bit k of a row's mask: the row is valid and reads a real row at k
    real = ((idx >= 0) & (idx < v_in) & valid[None, :]).numpy()
    masks = np.zeros(v_out, np.int64)
    for k in range(idx.shape[0]):
        masks |= real[k].astype(np.int64) << k
    np.testing.assert_array_equal(row_masks(idx, v_in, valid).numpy(), masks)
    np.testing.assert_array_equal(order.masks.numpy(), masks[perm.numpy()])
    m = order.masks.numpy()
    assert np.all(np.diff(m) >= 0)
    ties = np.diff(m) == 0
    assert np.all(np.diff(perm.numpy())[ties] > 0)      # stable
    again = rulebook_row_order(idx, v_in, valid)
    assert torch.equal(again.perm, order.perm)
    # the pad rows and the rows without a real entry come first
    assert int((order.masks == 0).sum()) >= int((~valid).sum())


def test_row_masks_take_at_most_64_offsets():
    """One int64 word a row takes at most 64 offsets; 65 to 128 take two
    words (the 5^3 stem's 125), and more raise."""
    idx = torch.zeros((129, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        row_masks(idx, 4, torch.ones(4, dtype=torch.bool))
    # 64 offsets use the sign bit and still come back bit for bit
    idx = torch.zeros((64, 3), dtype=torch.int32)
    idx[:, 1] = 3
    masks = row_masks(idx, 3, torch.tensor([True, True, False]))
    assert masks.tolist() == [-1, 0, 0]
    idx = torch.zeros((65, 3), dtype=torch.int32)
    idx[:, 1] = 3
    masks = row_masks(idx, 3, torch.tensor([True, True, False]))
    assert masks.tolist() == [[-1, 1], [0, 0], [0, 0]]


def _inputs(v_in, k, cin, cout, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(v_in, cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) * 0.2).astype(np.float32)
    return feats, w


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cin", [9, 16])
def test_plain_gather_conv_with_order_matches_jax(pyramid, kind, cin):
    v_in, idx, valid, order = _book(pyramid, kind)
    feats, w = _inputs(v_in, idx.shape[0], cin, 8, cin + len(kind))
    tf, tw = torch.from_numpy(feats), torch.from_numpy(w)
    got = gather_conv(tf, idx, tw, valid, order)
    np.testing.assert_allclose(got.numpy(),
                               gather_conv(tf, idx, tw, valid).numpy(),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(j_gather_conv(jnp.asarray(feats),
                                    jnp.asarray(idx.numpy()), jnp.asarray(w),
                                    jnp.asarray(valid.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[~valid.numpy()] == 0)


@pytest.mark.parametrize("kind", ["subm", "down"])
def test_plain_gather_conv_with_order_matches_pallas_interpret(pyramid,
                                                               kind):
    v_in, idx, valid, order = _book(pyramid, kind)
    feats, w = _inputs(v_in, idx.shape[0], 16, 16, 3)
    want = np.asarray(windowed_gather_conv_interpret(
        jnp.asarray(feats), jnp.asarray(idx.numpy()), jnp.asarray(w),
        jnp.asarray(valid.numpy())))
    got = gather_conv(torch.from_numpy(feats), idx, torch.from_numpy(w),
                      valid, order)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_scrambled_order_gives_the_same_result(pyramid):
    """Any permutation with its masks is honoured (tiles then mix masks
    on the card)."""
    v_in, idx, valid, _ = _book(pyramid, "subm")
    feats, w = _inputs(v_in, 27, 16, 8, 5)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(
        idx.shape[1]))
    order = RowOrder(perm.to(torch.int32), row_masks(idx, v_in, valid)[perm])
    tf, tw = torch.from_numpy(feats), torch.from_numpy(w)
    np.testing.assert_allclose(gather_conv(tf, idx, tw, valid, order).numpy(),
                               gather_conv(tf, idx, tw, valid).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_gradient_through_the_order(pyramid):
    """GatherConv with an order: same forward and gradients as without."""
    v_in, idx, valid, order = _book(pyramid, "down")
    feats, w = _inputs(v_in, idx.shape[0], 8, 8, 7)
    res = []
    for o in (order, None):
        tf = torch.from_numpy(feats).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        out = sparse_conv(tf, Book(idx, o), tw, valid)
        (out * out).sum().backward()
        res.append((out.detach(), tf.grad, tw.grad))
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_sparse_fpn_passes_every_book_its_order(pyramid, monkeypatch):
    """Every conv of the backbone gets its rulebook's RowOrder, and the
    maps equal those of a forward whose orders are all None."""
    tcfg, t0, pyr = pyramid
    model = SparseFPN(tcfg)
    gen = torch.Generator().manual_seed(0)
    for mod in model.modules():
        if hasattr(mod, "reset_parameters") and mod is not model:
            mod.reset_parameters(gen)
    seen = []
    plain = tsc.gather_conv

    def recorder(feats, idx, w, valid, order=None):
        seen.append(order)
        return plain(feats, idx, w, valid, order)

    monkeypatch.setattr(tsc, "gather_conv", recorder)
    with torch.inference_mode():
        rpn, roi = model(t0, pyr)
    assert seen and all(isinstance(o, RowOrder) for o in seen)
    bare = dict(pyr)
    for key in ("subm", "down", "up"):
        bare[key] = [b._replace(order=None) for b in pyr[key]]
    bare["bev"] = {s: (t, b._replace(order=None))
                   for s, (t, b) in pyr["bev"].items()}
    with torch.inference_mode():
        rpn0, roi0 = model(t0, bare)
    for a, b in zip(rpn + roi, rpn0 + roi0):
        np.testing.assert_allclose(a.feats.numpy(), b.feats.numpy(),
                                   rtol=1e-5, atol=1e-5)
