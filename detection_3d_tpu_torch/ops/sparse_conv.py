"""Sparse convolution: gather-GEMM over rulebooks.

Counterpart of detection_3d_tpu/ops/sparse_conv.py. Every sparse conv
of the backbone (submanifold, strided, deconv, BEV) is

    out[i] = sum_k feats[idx[k, i]] @ W[k]

over a (K, V_out) int32 rulebook whose entry V_in reads a zero row, with
weights laid out (K, Cin, Cout), f32 sums, output rows with ``out_valid``
false zeroed, and the output in the feats dtype.

Kernel A takes every rulebook with a :class:`RowOrder`
(:func:`rulebook_row_order`, built once per pyramid): its output rows
sorted by the mask of offsets at which they have a real entry. It runs
each tile of rows over the offsets its rows use, not over all K. The
result does not depend on the order.

:func:`sparse_conv` launches the hand-written CUDA kernel
(csrc/gather_conv.cu) for tensors on the card and takes the plain
:func:`gather_conv` for tensors on the CPU. When a gradient is wanted it
goes through :class:`GatherConv`. Its backward reads the rulebook's
:class:`BackwardBook` (built once per training pyramid): dFeats is kernel
A's code on the transposed book with W transposed, dW the kernel of
csrc/gather_conv_bwd.cu over the book's per-offset entry lists. On the
CPU the same route takes the plain versions (:func:`gather_conv_dfeats`,
:func:`gather_conv_dw`), so the CPU tests run the wiring the card runs;
:func:`gather_conv_backward` stays the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.multi_match import deconv_rulebook_match

MAX_OFFSETS = 64     # one bit per offset in an int64 row mask


class RowOrder(NamedTuple):
    """A rulebook's output rows grouped by offset mask: ``perm`` (V_out,)
    int32 is a permutation of the rows (stable sort by mask), ``masks``
    (V_out,) int64 holds at position p the mask of row ``perm[p]``: bit k
    set when that row is valid and has a real entry at offset k."""
    perm: torch.Tensor
    masks: torch.Tensor


class BackwardBook(NamedTuple):
    """What :class:`GatherConv`'s backward reads of a (K, V_out) rulebook
    over a V_in-row input (:func:`backward_book`). Its real entries are
    the (k, i) with ``idx[k, i]`` a real row and output row i valid.

    ``t_idx`` (K, V_in) int32 is the transposed book: ``t_idx[k, idx[k,
    i]] = i`` for each real entry, V_out elsewhere; with ``reversed`` it
    holds that book with its offsets in reverse order (a submanifold
    book, whose transpose is the book itself read so, ``idx.flip(0)``),
    and dFeats takes W[K - 1 - k] at offset k. ``t_order`` is the
    :class:`RowOrder` of ``t_idx`` (every row wanted). ``entries`` (nnz,
    2) int32 holds the real entries as (input row, output row) pairs,
    offset by offset, and ``starts`` (K + 1,) int32 where each offset's
    entries begin."""
    t_idx: torch.Tensor
    t_order: RowOrder
    entries: torch.Tensor
    starts: torch.Tensor
    reversed: bool = False


def _real_entries(neighbor_idx, v_in: int, out_valid):
    return ((neighbor_idx >= 0) & (neighbor_idx < v_in)
            & out_valid[None, :])


def row_masks(neighbor_idx, v_in: int, out_valid):
    """(V_out,) int64: bit k of row i set when ``out_valid[i]`` and
    ``neighbor_idx[k, i]`` is a real row (0 <= idx < v_in). K <= 64."""
    k = neighbor_idx.shape[0]
    if k > MAX_OFFSETS:
        raise ValueError(f"row masks take at most {MAX_OFFSETS} offsets, "
                         f"got {k}")
    dtype = torch.int32 if k <= 31 else torch.int64
    real = _real_entries(neighbor_idx, v_in, out_valid).to(dtype)
    bit = torch.ones((), dtype=torch.int64, device=neighbor_idx.device)
    weights = torch.bitwise_left_shift(
        bit, torch.arange(k, device=neighbor_idx.device)).to(dtype)
    return (real * weights[:, None]).sum(0, dtype=torch.int64)


def masks_row_order(masks) -> RowOrder:
    """The :class:`RowOrder` of a book whose row masks are known (kernel B
    writes them beside the submanifold book): one stable sort."""
    masks, perm = torch.sort(masks, stable=True)
    return RowOrder(perm.to(torch.int32), masks)


def rulebook_row_order(neighbor_idx, v_in: int, out_valid) -> RowOrder:
    """The :class:`RowOrder` of a (K, V_out) rulebook over a V_in-row
    input (computed once per pyramid, reused by every conv on the book)."""
    return masks_row_order(row_masks(neighbor_idx, v_in, out_valid))


def transpose_rulebook(neighbor_idx, v_in: int, out_valid):
    """(t_idx, RowOrder): the (K, V_in) transposed book of a (K, V_out)
    rulebook (see :class:`BackwardBook`) by one scatter, and its row
    order. Raises ValueError when two real entries of one offset read the
    same input row: such a book has no transpose."""
    k, v_out = neighbor_idx.shape
    dev = neighbor_idx.device
    real = _real_entries(neighbor_idx, v_in, out_valid)
    flat = torch.where(real, torch.arange(k, device=dev)[:, None] * v_in
                       + neighbor_idx.to(torch.int64), k * v_in)
    rows = torch.arange(v_out, dtype=torch.int32, device=dev).expand(k,
                                                                     v_out)
    t = torch.full((k * v_in + 1,), v_out, dtype=torch.int32, device=dev)
    t[flat] = rows
    if bool(((t[flat] != rows) & real).any()):
        raise ValueError("transpose_rulebook: two entries of one offset "
                         "read the same input row")
    t = t[:k * v_in].view(k, v_in)
    every = torch.ones(v_in, dtype=torch.bool, device=dev)
    return t, rulebook_row_order(t, v_out, every)


def rulebook_entries(neighbor_idx, v_in: int, out_valid):
    """(entries (nnz, 2) int32, starts (K + 1,) int32): the real entries
    of a rulebook as (input row, output row) pairs, k-major (see
    :class:`BackwardBook`)."""
    real = _real_entries(neighbor_idx, v_in, out_valid)
    nz = torch.nonzero(real)
    entries = torch.stack([neighbor_idx[nz[:, 0], nz[:, 1]],
                           nz[:, 1].to(torch.int32)], 1)
    starts = torch.zeros(real.shape[0] + 1, dtype=torch.int32,
                         device=real.device)
    starts[1:] = torch.cumsum(real.sum(1), 0)
    return entries, starts


def backward_book(neighbor_idx, v_in: int, out_valid) -> BackwardBook:
    """The :class:`BackwardBook` of a rulebook, by the scatter and
    :func:`rulebook_entries`."""
    return BackwardBook(*transpose_rulebook(neighbor_idx, v_in, out_valid),
                        *rulebook_entries(neighbor_idx, v_in, out_valid))


def _acc_dtype(feats):
    """f32 sums for f32 and bf16 features (f64 for f64, which only the
    gradient checks use)."""
    return torch.promote_types(feats.dtype, torch.float32)


def gather_conv(feats, neighbor_idx, weights, out_valid,
                order: Optional[RowOrder] = None):
    """Plain version: sum_k gather(feats, idx[k]) @ W[k] in f32.

    Args:
      feats: (V_in, Cin); neighbor_idx: (K, V_out) int32 (V_in => zero);
      weights: (K, Cin, Cout); out_valid: (V_out,) bool; order: optional
      :class:`RowOrder` of the rulebook (rows computed in that order and
      written back at their own index, as the kernel does).
    Returns (V_out, Cout) in feats.dtype.
    """
    if order is None:
        return _gather_conv_rows(feats, neighbor_idx, weights, out_valid)
    perm = order.perm.to(torch.int64)
    got = _gather_conv_rows(feats, neighbor_idx[:, perm], weights,
                            out_valid[perm])
    return torch.empty_like(got).index_copy_(0, perm, got)


def _gather_conv_rows(feats, neighbor_idx, weights, out_valid):
    acc = _acc_dtype(feats)
    src = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))], 0)
    v_out = neighbor_idx.shape[1]
    out = torch.zeros((v_out, weights.shape[-1]), dtype=acc,
                      device=feats.device)
    for k in range(neighbor_idx.shape[0]):   # one (V_out, Cin) gather held
        rows = src[neighbor_idx[k].to(torch.int64)]
        out += rows.to(acc) @ weights[k].to(acc)
    out = torch.where(out_valid[:, None], out, 0.0)
    return out.to(feats.dtype)


def gather_conv_backward(feats, neighbor_idx, weights, out_valid, g):
    """Plain version of the backward: the VJP of :func:`gather_conv`.

    ``g`` (V_out, Cout) is masked by ``out_valid``; the pad row's
    gradient is dropped. Sums in f32. Returns (d_feats (V_in, Cin) in
    feats.dtype, d_w (K, Cin, Cout) in weights.dtype).
    """
    v_in, cin = feats.shape
    acc = _acc_dtype(feats)
    gm = torch.where(out_valid[:, None], g.to(acc), 0.0)
    wa = weights.to(acc)
    src = torch.cat([feats.to(acc), feats.new_zeros((1, cin), dtype=acc)],
                    0)
    d_src = torch.zeros_like(src)
    d_w = torch.empty_like(wa)
    for k in range(neighbor_idx.shape[0]):
        idx_k = neighbor_idx[k].to(torch.int64)
        d_w[k] = src[idx_k].T @ gm
        d_src.index_add_(0, idx_k, gm @ wa[k].T)
    return d_src[:v_in].to(feats.dtype), d_w.to(weights.dtype)


def _dfeats_weights(weights, book: BackwardBook):
    """W transposed to (K, Cout, Cin), its offsets reversed where the book
    is stored reversed."""
    w_t = weights.transpose(1, 2)
    return w_t.flip(0) if book.reversed else w_t


def gather_conv_dfeats(g, weights, book: BackwardBook):
    """Plain version of dFeats as the card computes it: :func:`gather_conv`
    of ``g`` over the transposed book with W transposed, every input row
    wanted. Equals :func:`gather_conv_backward`'s first result."""
    every = torch.ones(book.t_idx.shape[1], dtype=torch.bool,
                       device=g.device)
    return gather_conv(g, book.t_idx, _dfeats_weights(weights, book), every,
                       book.t_order)


def gather_conv_dw(feats, g, book: BackwardBook):
    """Plain version of dW over the entry lists: dW[k] = sum over offset
    k's entries (r, i) of feats[r]^T g[i], f32 sums, in feats.dtype.
    Equals :func:`gather_conv_backward`'s second result."""
    acc = _acc_dtype(feats)
    starts = book.starts.tolist()
    d_w = torch.empty((len(starts) - 1, feats.shape[1], g.shape[1]),
                      dtype=acc, device=feats.device)
    for k in range(len(starts) - 1):
        e = book.entries[starts[k]:starts[k + 1]].to(torch.int64)
        d_w[k] = feats[e[:, 0]].to(acc).T @ g[e[:, 1]].to(acc)
    return d_w.to(feats.dtype)


_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_conv_args(name, feats, neighbor_idx, weights, order):
    """Raise on what kernel A does not take; returns feats, idx, weights
    and the order's perm and masks, made contiguous."""
    v_in, cin = feats.shape
    n_off, v_out = neighbor_idx.shape
    cout = weights.shape[-1]
    perm, masks = order
    if feats.dtype not in _DTYPE_TAG or weights.dtype != feats.dtype:
        raise ValueError(f"{name}: feats {feats.dtype} / weights "
                         f"{weights.dtype}: expected both float32 or both "
                         "bfloat16")
    if (neighbor_idx.dtype != torch.int32
            or weights.shape != (n_off, cin, cout)):
        raise ValueError(f"{name}: expected int32 idx (K, V_out) and "
                         "weights (K, Cin, Cout)")
    if n_off > MAX_OFFSETS:
        raise ValueError(f"{name}: at most {MAX_OFFSETS} offsets, got "
                         f"{n_off}")
    if (perm.dtype != torch.int32 or masks.dtype != torch.int64
            or perm.shape != (v_out,) or masks.shape != (v_out,)):
        raise ValueError(f"{name}: order must be int32 perm and int64 masks "
                         "of shape (V_out,)")
    for t in (neighbor_idx, weights, perm, masks):
        if t.device != feats.device:
            raise ValueError(f"{name}: inputs on different devices")
    return tuple(t.contiguous()
                 for t in (feats, neighbor_idx, weights, perm, masks))


def _aligned16(t):
    """``t`` itself when its data starts on a 16-byte boundary (the bf16
    kernels' 16-byte copies), else a copy that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_a(role, feats, neighbor_idx, weights, order: RowOrder):
    """Launch kernel A through its C entry ``role``: "gather_conv" (the
    forward) or "gather_conv_dfeats" (the same kernel body under a kernel
    symbol of its own, so a device profile tells the two apart). Counts
    the launch under ``role``."""
    feats, neighbor_idx, weights, perm, masks = _check_conv_args(
        role, feats, neighbor_idx, weights, order)
    v_in, cin = feats.shape
    v_out = neighbor_idx.shape[1]
    cout = weights.shape[-1]
    dev = feats.device
    cout_k = cout
    if feats.dtype == torch.bfloat16:
        pad_c, pad_o = (-cin) % 16, (-cout) % 8
        if pad_c:
            feats = F.pad(feats, (0, pad_c))
            weights = F.pad(weights, (0, 0, 0, pad_c))
        if pad_o:
            weights = F.pad(weights, (0, pad_o))
        feats, weights = _aligned16(feats), _aligned16(weights)
        cin, cout_k = cin + pad_c, cout + pad_o
    out = torch.empty((v_out, cout_k), dtype=feats.dtype, device=dev)
    if v_out == 0 or cout == 0:
        return out[:, :cout]
    fn = getattr(cuda_lib.library("gather_conv"),
                 f"{role}_{_DTYPE_TAG[feats.dtype]}")
    status = fn(feats.data_ptr(), neighbor_idx.data_ptr(),
                weights.data_ptr(), perm.data_ptr(), masks.data_ptr(),
                out.data_ptr(), v_in, v_out, cin, cout_k,
                cuda_lib.stream_ptr(dev))
    cuda_lib.check("gather_conv", status)
    cuda_lib.launches[role] += 1
    return out if cout_k == cout else out[:, :cout].contiguous()


def gather_conv_cuda(feats, neighbor_idx, weights, out_valid,
                     order: Optional[RowOrder] = None):
    """Kernel A on the card: same contract as :func:`gather_conv`. The
    kernel takes ``out_valid`` through the row order, built here when
    none is given. In bf16, Cin is zero-padded to a multiple of 16 and
    Cout to a multiple of 8 when they are not (the input conv's Cin =
    9)."""
    if (out_valid.dtype != torch.bool
            or out_valid.shape != (neighbor_idx.shape[1],)
            or out_valid.device != feats.device):
        raise ValueError("gather_conv_cuda: expected a bool out_valid "
                         "(V_out,) on the feats' device")
    if order is None:
        order = rulebook_row_order(neighbor_idx, feats.shape[0], out_valid)
    return _kernel_a("gather_conv", feats, neighbor_idx, weights, order)


def gather_conv_dfeats_cuda(g, weights, book: BackwardBook):
    """dFeats on the card: kernel A's code on the transposed book with W
    transposed (its "gather_conv_dfeats" entry), same contract as
    :func:`gather_conv_dfeats`. Each input row is written once, so the
    result is the same bits on every call."""
    return _kernel_a("gather_conv_dfeats", g, book.t_idx,
                     _dfeats_weights(weights, book), book.t_order)


# dW's work items: about DW_BLOCKS blocks per call, each a run of at least
# DW_MIN_ENTRIES entries (one stage of the bf16 kernel) of one offset
DW_BLOCKS = 1024
DW_MIN_ENTRIES = 64


def _dw_tile(c):
    """The kernel's tile width along Cin or Cout (csrc/gather_conv_bwd.cu)."""
    return 32 if c <= 32 else 64


def gather_conv_dw_cuda(feats, g, book: BackwardBook):
    """dW on the card (csrc/gather_conv_bwd.cu), same contract as
    :func:`gather_conv_dw`. Each block takes one work item (a run of at
    most ``per_item`` entries of one offset, one Cin x Cout tile) and
    writes its f32 partial tile to a scratch; a second kernel sums each
    offset's partials in a fixed order, so the result is the same bits on
    every call. In bf16, Cin and Cout are zero-padded to multiples of 8
    (16-byte copies)."""
    entries, starts = book.entries, book.starts
    dtype, dev = feats.dtype, feats.device
    n_off = starts.numel() - 1
    if dtype not in _DTYPE_TAG or g.dtype != dtype:
        raise ValueError(f"gather_conv_dw_cuda: feats {dtype} / g "
                         f"{g.dtype}: expected both float32 or both bfloat16")
    if (entries.dtype != torch.int32 or starts.dtype != torch.int32
            or entries.ndim != 2 or entries.shape[1] != 2
            or starts.ndim != 1 or n_off < 0 or feats.ndim != 2
            or g.ndim != 2):
        raise ValueError("gather_conv_dw_cuda: expected int32 entries "
                         "(nnz, 2), int32 starts (K + 1,), feats (V_in, "
                         "Cin) and g (V_out, Cout)")
    for t in (g, entries, starts):
        if t.device != dev:
            raise ValueError("gather_conv_dw_cuda: inputs on different "
                             "devices")
    cin, cout = feats.shape[1], g.shape[1]
    if n_off == 0 or cin == 0 or cout == 0:
        return torch.zeros((n_off, cin, cout), dtype=dtype, device=dev)
    feats, g = feats.contiguous(), g.contiguous()
    entries, starts = _aligned16(entries.contiguous()), starts.contiguous()
    if dtype == torch.bfloat16:
        if cin % 8:
            feats = F.pad(feats, (0, (-cin) % 8))
        if cout % 8:
            g = F.pad(g, (0, (-cout) % 8))
        feats, g = _aligned16(feats), _aligned16(g)
    cin_k, cout_k = feats.shape[1], g.shape[1]
    nnz = entries.shape[0]
    tiles = -(-cin_k // _dw_tile(cin_k)) * -(-cout_k // _dw_tile(cout_k))
    per_item = -(-max(DW_MIN_ENTRIES, -(-nnz // max(1, DW_BLOCKS // tiles)))
                 // DW_MIN_ENTRIES) * DW_MIN_ENTRIES
    # sum over offsets of ceil(n_k / per_item) <= nnz // per_item + K
    n_items = nnz // per_item + n_off
    partial = torch.empty((n_items, cin_k, cout_k), dtype=torch.float32,
                          device=dev)
    out = torch.empty((n_off, cin_k, cout_k), dtype=dtype, device=dev)
    fn = getattr(cuda_lib.library("gather_conv_bwd"),
                 f"gather_conv_dw_{_DTYPE_TAG[dtype]}")
    status = fn(feats.data_ptr(), g.data_ptr(), entries.data_ptr(),
                starts.data_ptr(), partial.data_ptr(), out.data_ptr(), n_off,
                cin_k, cout_k, per_item, n_items, cuda_lib.stream_ptr(dev))
    cuda_lib.check("gather_conv_bwd", status)
    cuda_lib.launches["gather_conv_dw"] += 1
    if (cin_k, cout_k) != (cin, cout):
        out = out[:, :cin, :cout].contiguous()
    return out


class GatherConv(torch.autograd.Function):
    """Sparse conv with its gradient: kernel A forward on the card,
    :func:`gather_conv` on the CPU. The backward reads the rulebook's
    :class:`BackwardBook` ``bwd`` (built here when None) and forms dFeats
    with :func:`gather_conv_dfeats_cuda` and dW with
    :func:`gather_conv_dw_cuda` on the card, their plain versions on the
    CPU, each only when its input wants a gradient. The index, mask, row
    order and book get none."""

    @staticmethod
    def forward(ctx, feats, neighbor_idx, weights, out_valid, order=None,
                bwd=None):
        ctx.save_for_backward(feats, neighbor_idx, weights, out_valid)
        ctx.bwd = bwd
        if feats.is_cuda:
            return gather_conv_cuda(feats, neighbor_idx, weights, out_valid,
                                    order)
        return gather_conv(feats, neighbor_idx, weights, out_valid, order)

    @staticmethod
    def backward(ctx, g):
        feats, idx, weights, valid = ctx.saved_tensors
        need_feats, _, need_w = ctx.needs_input_grad[:3]
        book = ctx.bwd
        if book is None:
            book = backward_book(idx, feats.shape[0], valid)
        d_feats = d_w = None
        if need_feats:
            d_feats = (gather_conv_dfeats_cuda if g.is_cuda
                       else gather_conv_dfeats)(g, weights, book)
        if need_w:
            d_w = (gather_conv_dw_cuda if g.is_cuda
                   else gather_conv_dw)(feats, g, book).to(weights.dtype)
        return d_feats, None, d_w, None, None, None


def sparse_conv(feats, neighbor_idx, weights, out_valid,
                order: Optional[RowOrder] = None,
                bwd: Optional[BackwardBook] = None, halo=None):
    """Kernel A for tensors on the card, the plain version on the CPU;
    through :class:`GatherConv` when a gradient is wanted. ``order`` is
    the rulebook's :class:`RowOrder` (kernel A's wrapper builds one when
    it is None), ``bwd`` its :class:`BackwardBook` (the backward builds
    one when it is None). ``halo``, a book's
    parallel/spatial.HaloExchange on a spatially sharded table, first
    refreshes the input's halo rows from the neighbouring shards (JAX
    ops/sparse_conv.py:71-81)."""
    if halo is not None:
        feats = halo.refresh(feats)
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weights.requires_grad):
        return GatherConv.apply(feats, neighbor_idx, weights, out_valid,
                                order, bwd)
    if feats.is_cuda:
        return gather_conv_cuda(feats, neighbor_idx, weights, out_valid,
                                order)
    return gather_conv(feats, neighbor_idx, weights, out_valid, order)


def submanifold_conv(table_feats, neighbor_idx, weights, out_valid,
                     order: Optional[RowOrder] = None,
                     bwd: Optional[BackwardBook] = None, halo=None):
    """Submanifold conv: output sites == input sites (27-offset book)."""
    return sparse_conv(table_feats, neighbor_idx, weights, out_valid, order,
                       bwd, halo)


def strided_conv(in_feats, rulebook_idx, weights, out_valid,
                 order: Optional[RowOrder] = None,
                 bwd: Optional[BackwardBook] = None):
    """Strided (downsampling) or z-collapsing BEV conv over its book."""
    return sparse_conv(in_feats, rulebook_idx, weights, out_valid, order,
                       bwd)


def deconv(in_feats, rulebook_idx, weights, out_valid,
           order: Optional[RowOrder] = None,
           bwd: Optional[BackwardBook] = None, halo=None):
    """Transposed conv back onto a finer table: ``rulebook_idx`` (K,
    V_fine) indexes the coarse table (the reversed strided book)."""
    return sparse_conv(in_feats, rulebook_idx, weights, out_valid, order,
                       bwd, halo)


def nin_conv(feats, weight, out_valid):
    """1x1x1 (NetworkInNetwork) conv: one plain matmul over the rows."""
    out = feats @ weight
    return torch.where(out_valid[:, None], out, 0.0).to(feats.dtype)


def deconv_rulebook(fine_table, coarse_table, kernel, stride):
    """(K, V_fine) deconv rulebook by search: entry [k, x] is the coarse
    row o with fine_coord(x) == o * stride + offset_k, V_coarse where
    absent (JAX ops/sparse_conv.py:107). Kernel D on the card
    (ops/multi_match.deconv_rulebook_match)."""
    return deconv_rulebook_match(fine_table, coarse_table, kernel, stride)
