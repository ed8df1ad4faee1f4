"""The sparse-conv backward's books (ops/sparse_conv.BackwardBook), on the
CPU.

GatherConv's backward forms dFeats as kernel A on the transposed book
with W transposed, and dW over the book's per-offset entry lists. Here,
on every kind of book ``build_pyramid`` makes (submanifold at two
scales, strided, deconv, BEV):

  * ``transpose_rulebook`` equals its definition, and the book with its
    offsets reversed for the submanifold books;
  * the training pyramid's backward books stand for what the scatter
    gives, bit for bit, where they are taken from another book (a
    submanifold book read with its offsets reversed, the down/up pair),
    also when a downsample drops coarse rows at its capacity;
  * the plain dFeats on the transposed book and the plain dW over the
    entry lists equal ``gather_conv_backward`` and ``jax.vjp`` of the JAX
    package's ``gather_conv`` (atol 1e-5: f32 sums in another order);
  * the serving pyramid builds no backward book.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops.sparse_conv import gather_conv as j_gather_conv
from detection_3d_tpu_torch.models import backbone as tbackbone
from detection_3d_tpu_torch.models.backbone import build_pyramid
from detection_3d_tpu_torch.ops import sparse_conv as tsc
from detection_3d_tpu_torch.ops.sparse import downsample_with_rulebooks
from detection_3d_tpu_torch.ops.sparse_conv import (
    BackwardBook, Book, GatherConv, backward_book, gather_conv,
    gather_conv_backward, gather_conv_dfeats, gather_conv_dw,
    rulebook_entries, rulebook_row_order, sparse_conv, transpose_rulebook,
)
from test_torch_common import cfg_pair, scene_tables

KINDS = ["subm", "subm_s2", "strided", "deconv", "bev"]


@pytest.fixture(scope="module")
def pyramid():
    jcfg, tcfg = cfg_pair()
    _, t0 = scene_tables(jcfg, tcfg)
    return tcfg, t0, build_pyramid(t0, tcfg, backward=True)


def _book(pyramid, kind):
    """(V_in, idx, out_valid, the pyramid's BackwardBook) of one kind."""
    tcfg, _, pyr = pyramid
    tables = pyr["tables"]
    n = len(tables)
    if kind == "subm":
        book, v_in, valid = pyr["subm"][0], tables[0].capacity, \
            tables[0].row_valid
    elif kind == "subm_s2":
        book, v_in, valid = pyr["subm"][2], tables[2].capacity, \
            tables[2].row_valid
    elif kind == "strided":
        book, v_in, valid = pyr["down"][0], tables[0].capacity, \
            tables[1].row_valid
    elif kind == "deconv":  # level order: up[0] maps scale 1 onto 0
        book, v_in, valid = pyr["up"][0], tables[1].capacity, \
            tables[0].row_valid
    else:
        bev_t, book = pyr["bev"][0]
        src = tables[n - 1 - tcfg.rpn.rpn_scales_from_top[0]]
        v_in, valid = src.capacity, bev_t.row_valid
    return v_in, book.idx, valid, book.bwd


def _real(idx, v_in, valid):
    return ((idx >= 0) & (idx < v_in) & valid[None, :]).numpy()


def _orders_equal(a, b):
    return torch.equal(a.perm, b.perm) and torch.equal(a.masks, b.masks)


@pytest.mark.parametrize("kind", KINDS)
def test_transpose_rulebook_is_its_definition(pyramid, kind):
    v_in, idx, valid, _ = _book(pyramid, kind)
    k, v_out = idx.shape
    real = _real(idx, v_in, valid)
    assert real.sum() > 0, "the book holds real entries"
    want = np.full((k, v_in), v_out, np.int32)
    ks, rows = np.nonzero(real)
    want[ks, idx.numpy()[ks, rows]] = rows
    t, order = transpose_rulebook(idx, v_in, valid)
    assert t.dtype == torch.int32 and t.shape == (k, v_in)
    np.testing.assert_array_equal(t.numpy(), want)
    assert _orders_equal(order, rulebook_row_order(
        t, v_out, torch.ones(v_in, dtype=torch.bool)))
    if kind.startswith("subm"):
        # offset k is the negation of offset K - 1 - k
        assert torch.equal(t, idx.flip(0))


@pytest.mark.parametrize("kind", KINDS)
def test_pyramid_books_equal_the_scatter(pyramid, kind):
    """The training pyramid's books, taken from another book where one
    is known, stand for what the scatter and ``rulebook_entries`` give:
    the transposed book bit for bit (a submanifold book's read with its
    offsets reversed), its order the row order of the book as stored,
    and each offset's entries the same pairs (a deconv book's in the
    order of its conv book's)."""
    v_in, idx, valid, book = _book(pyramid, kind)
    v_out = idx.shape[1]
    assert book.reversed == kind.startswith("subm")
    t, order = transpose_rulebook(idx, v_in, valid)
    assert torch.equal(book.t_idx.flip(0) if book.reversed else book.t_idx,
                       t)
    assert _orders_equal(book.t_order, rulebook_row_order(
        book.t_idx, v_out, torch.ones(v_in, dtype=torch.bool)))
    if not book.reversed:
        assert _orders_equal(book.t_order, order)
    entries, starts = rulebook_entries(idx, v_in, valid)
    assert torch.equal(book.starts, starts)
    if kind != "deconv":
        assert torch.equal(book.entries, entries)
    for k in range(idx.shape[0]):
        a, b = (e[starts[k]:starts[k + 1]].numpy()
                for e in (book.entries, entries))
        np.testing.assert_array_equal(a[np.lexsort(a.T[::-1])],
                                      b[np.lexsort(b.T[::-1])])


def test_down_up_books_transpose_under_capacity_overflow(pyramid):
    """A downsample that drops coarse rows at its capacity: its conv and
    deconv books are still each other's transposes, row orders too."""
    _, t0, _ = pyramid
    coarse, crb, drb = downsample_with_rulebooks(t0, (2, 2, 2), (2, 2, 2),
                                                 64)
    assert int(coarse.true_num) > coarse.capacity, "the capacity overflows"
    fine_v, coarse_v = t0.row_valid, coarse.row_valid
    t, order = transpose_rulebook(crb, t0.capacity, coarse_v)
    assert torch.equal(t, drb)
    assert _orders_equal(order, rulebook_row_order(drb, coarse.capacity,
                                                   fine_v))
    t, order = transpose_rulebook(drb, coarse.capacity, fine_v)
    assert torch.equal(t, crb)
    assert _orders_equal(order, rulebook_row_order(crb, t0.capacity,
                                                   coarse_v))


@pytest.mark.parametrize("kind", KINDS)
def test_entry_lists_hold_the_real_entries(pyramid, kind):
    v_in, idx, valid, _ = _book(pyramid, kind)
    entries, starts = rulebook_entries(idx, v_in, valid)
    real = _real(idx, v_in, valid)
    starts = starts.numpy()
    assert entries.dtype == torch.int32
    assert starts[0] == 0 and starts[-1] == real.sum() == entries.shape[0]
    for k in range(idx.shape[0]):
        e = entries[starts[k]:starts[k + 1]].numpy()
        rows = np.nonzero(real[k])[0]
        np.testing.assert_array_equal(e[:, 1], rows)       # k-major, sorted
        np.testing.assert_array_equal(e[:, 0], idx.numpy()[k, rows])


def _inputs(v_in, k, cin, cout, v_out, seed):
    rng = np.random.RandomState(seed)
    feats = rng.normal(0, 1, (v_in, cin)).astype(np.float32)
    w = (rng.normal(0, 1, (k, cin, cout)) / np.sqrt(k * cin)).astype(
        np.float32)
    g = (0.05 * rng.normal(0, 1, (v_out, cout))).astype(np.float32)
    return feats, w, g


def _jax_vjp(feats, idx, w, valid, g):
    _, vjp = jax.vjp(lambda f, ww: j_gather_conv(
        f, jnp.asarray(idx.numpy()), ww, jnp.asarray(valid.numpy())),
        jnp.asarray(feats), jnp.asarray(w))
    return tuple(np.asarray(a) for a in vjp(jnp.asarray(g)))


@pytest.mark.parametrize("kind", KINDS)
def test_dfeats_on_the_transposed_book(pyramid, kind):
    v_in, idx, valid, book = _book(pyramid, kind)
    k, v_out = idx.shape
    feats, w, g = _inputs(v_in, k, 8, 12, v_out, seed=3 * k + v_in)
    got = gather_conv_dfeats(torch.from_numpy(g), torch.from_numpy(w), book)
    want, _ = gather_conv_backward(torch.from_numpy(feats), idx,
                                   torch.from_numpy(w), valid,
                                   torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (v_in, 8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    want_j, _ = _jax_vjp(feats, idx, w, valid, g)
    np.testing.assert_allclose(got.numpy(), want_j, atol=1e-5, rtol=0)
    # an input row that no valid output reads (a pad row among them)
    # comes out exactly zero
    touched = np.zeros(v_in, bool)
    touched[idx.numpy()[_real(idx, v_in, valid)]] = True
    assert (~touched).any()
    assert np.all(got.numpy()[~touched] == 0)


@pytest.mark.parametrize("kind", KINDS)
def test_dw_over_the_entry_lists(pyramid, kind):
    v_in, idx, valid, book = _book(pyramid, kind)
    k, v_out = idx.shape
    feats, w, g = _inputs(v_in, k, 8, 12, v_out, seed=5 * k + v_in)
    got = gather_conv_dw(torch.from_numpy(feats), torch.from_numpy(g), book)
    _, want = gather_conv_backward(torch.from_numpy(feats), idx,
                                   torch.from_numpy(w), valid,
                                   torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (k, 8, 12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    _, want_j = _jax_vjp(feats, idx, w, valid, g)
    np.testing.assert_allclose(got.numpy(), want_j, atol=1e-5, rtol=0)


def test_transpose_rulebook_raises_on_a_repeated_input_row():
    """Offset 1 reads input row 2 from two valid outputs: no transpose.
    The same repeat on an invalid output row is no entry and passes."""
    idx = torch.tensor([[0, 1, 4, 3], [2, 4, 2, 1]], dtype=torch.int32)
    with pytest.raises(ValueError):
        transpose_rulebook(idx, 4, torch.ones(4, dtype=torch.bool))
    valid = torch.tensor([True, True, False, True])
    t, _ = transpose_rulebook(idx, 4, valid)
    assert t.tolist() == [[0, 1, 4, 3], [4, 3, 0, 4]]
    # and the backward that builds its own book refuses such a book too
    feats = torch.randn((4, 2), requires_grad=True)
    w = torch.randn((2, 2, 3), requires_grad=True)
    out = sparse_conv(feats, Book(idx, None), w,
                      torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        out.sum().backward()


def test_serving_pyramid_builds_no_backward_books(pyramid, monkeypatch):
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    tcfg, t0, _ = pyramid
    plain = build_pyramid(t0, tcfg)
    assert all(b.bwd is None for kind in ("subm", "down", "up")
               for b in plain[kind])
    assert all(b.bwd is None for _, b in plain["bev"].values())
    made = []
    for module, name, fn in ((tsc, "backward_book", backward_book),
                             (tbackbone, "rulebook_entries",
                              rulebook_entries)):
        monkeypatch.setattr(module, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            made.append(_n) or _fn(*a, **kw))
    model = SparseRCNN(tcfg, seed=0)
    with torch.inference_mode():
        model(t0)
    assert made == []
    # the training pyramid holds one book per rulebook: the entry lists of
    # each submanifold and conv book (a deconv book shares its conv
    # book's), the BEV books by the scatter
    books = build_pyramid(t0, tcfg, backward=True)
    n = len(books["tables"])
    assert made.count("rulebook_entries") == n + (n - 1)
    assert made.count("backward_book") == len(books["bev"])
    assert all(isinstance(b.bwd, BackwardBook)
               for key in ("subm", "down", "up")
               for b in books[key])


@pytest.mark.parametrize("kind", ["subm", "strided", "deconv"])
def test_gather_conv_backward_reads_the_pyramid_book(pyramid, kind,
                                                     monkeypatch):
    """With its book GatherConv builds none and gives the gradients it
    gives when it builds its own (1e-6: a submanifold book, read with its
    offsets reversed, sums in another order)."""
    v_in, idx, valid, book = _book(pyramid, kind)
    k, v_out = idx.shape
    feats, w, g = _inputs(v_in, k, 4, 6, v_out, seed=k)
    res = []
    for bwd in (None, book):
        tf = torch.from_numpy(feats).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        out = GatherConv.apply(tf, idx, tw, valid, None, bwd)
        if bwd is not None:
            monkeypatch.setattr(tsc, "backward_book", None)  # not called
        out.backward(torch.from_numpy(g))
        res.append((tf.grad, tw.grad))
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(res[0][0].numpy(), gather_conv(
        torch.from_numpy(g), book.t_idx, tsc._dfeats_weights(
            torch.from_numpy(w), book), torch.ones(v_in, dtype=torch.bool),
        book.t_order).numpy(), atol=1e-6, rtol=0)
