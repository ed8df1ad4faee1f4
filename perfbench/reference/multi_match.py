"""Query-key match against a sorted voxel table (kernel D).

Counterpart of the sorted-match entry points of
detection_3d_tpu/ops/pallas/match_kernel.py: :func:`sorted_multi_match`
answers (G, V_q) query keys with the table rows that hold them (the
table capacity V where none does), and :func:`conv_rulebook_match` /
:func:`deconv_rulebook_match` build the strided-conv and deconv
rulebooks with it. The single-card pyramid takes those books from the
downsample scatter instead (ops/sparse.downsample_with_rulebooks); the
spatial shard pyramids (parallel/spatial.py) and the searched-book
entry points ops/sparse.conv_rulebook and ops/sparse_conv.deconv_rulebook
(the JAX package's names) call these functions.

:func:`multi_match` launches the hand-written CUDA kernel
(csrc/multi_match.cu) for tensors on the card, in one of three forms
chosen from the sizes (:func:`multi_match_form`): a 4-ary search for
small query sets, warp compaction for large sets of mostly invalid
queries (deconv books), a binary search otherwise. On the CPU it
takes the same choice in torch: :func:`multi_match_quad`, the 4-ary
form's algorithm, or the plain :func:`multi_match_plain` (one
``searchsorted`` over the 64-bit composite key, as kernel B's plain
version), which is what the other two forms compute. All are equal bit
for bit. Unlike the TPU kernel, none needs the queries sorted.
"""

from __future__ import annotations

import torch

from perfbench.reference.coords import (
    INVALID, composite_key, key_search, pack_key,
)
from perfbench.reference.sparse import SparseTensor


def multi_match_plain(keys, queries):
    """Plain version: (N,) int64 composite queries -> (N,) int32 rows of
    the sorted (V,) int64 ``keys`` holding them, V where none does or the
    query is invalid (high half INVALID)."""
    idx, found = key_search(keys, queries >> 32, queries & 0xFFFFFFFF)
    return torch.where(found, idx, keys.shape[0]).to(torch.int32)


# kernel D's forms (csrc/multi_match.cu): the 4-ary search up to this many
# queries (one wave of the card: the chain's latency is the time), warp
# compaction from COMPACT_MIN_N queries where they are at least
# COMPACT_PER_ROW a table row (a deconv book's, 1 in 8 valid at stride
# 2), the binary search otherwise
QUAD_MAX_N = 1 << 16
COMPACT_MIN_N = 1 << 20
COMPACT_PER_ROW = 8
FORMS = {"binary": 1, "quad": 2, "compact": 3}

_TOP = torch.iinfo(torch.int64).max   # above every key


def multi_match_form(v: int, n: int) -> str:
    """The form of kernel D that (V,) keys and (N,) queries take."""
    if n <= QUAD_MAX_N:
        return "quad"
    if n >= COMPACT_MIN_N and n >= COMPACT_PER_ROW * v:
        return "compact"
    return "binary"


def multi_match_quad(keys, queries):
    """The 4-ary form of kernel D in torch: the same contract and bits as
    :func:`multi_match_plain`. The top holds the keys at stride 4^L
    (L the least with ceil(V / 4^L) <= 4), p of them below the query;
    each level below loads the 3 keys of stride 4^l between the
    bracket's ends 4(p - 1) and 4p, and p becomes 4(p - 1) + 1 + those
    below the query (rows past V above every query). The bracket's
    upper key is carried down: at the last level it is the key at the
    lower bound p."""
    v = keys.shape[0]
    levels = 0
    while -(-v // 4 ** levels) > 4:
        levels += 1

    def at(rows):
        return torch.where(rows < v, keys[rows.clamp(0, max(v - 1, 0))],
                           _TOP)

    top = at(torch.arange(4, device=keys.device) * 4 ** levels)
    below = top[None, :] < queries[:, None]
    p = below.sum(1)
    ub = torch.cat([top, top.new_tensor([_TOP])])[p]
    for level in range(levels - 1, -1, -1):
        base = 4 * (p - 1)
        e = at((base[:, None] + torch.arange(1, 4, device=keys.device))
               * 4 ** level)
        c = (e < queries[:, None]).sum(1)
        inside = p > 0
        ub = torch.where(inside & (c < 3),
                         e.gather(1, c.clamp(max=2)[:, None])[:, 0], ub)
        p = torch.where(inside, base + 1 + c, p)
    found = (ub == queries) & ((queries >> 32) != INVALID)
    return torch.where(found, p, v).to(torch.int32)


def multi_match(keys, queries):
    """The query-key match in torch: :func:`multi_match_quad` or the
    plain lower bound, by :func:`multi_match_form`."""
    if multi_match_form(keys.shape[0], queries.shape[0]) == "quad":
        return multi_match_quad(keys, queries)
    return multi_match_plain(keys, queries)


def sorted_multi_match(qhi, qlo, qvalid, table: SparseTensor):
    """(G, V_q) int32 query keys -> (G, V_q) int32 rows of ``table``;
    ``table.capacity`` where a query is invalid or absent. (The JAX
    kernel wants each row's valid queries sorted; this one does not.)"""
    qhi = torch.where(qvalid, qhi, INVALID)
    qlo = torch.where(qvalid, qlo, INVALID)
    q = composite_key(qhi, qlo)
    return multi_match(table.keys, q.reshape(-1)).reshape(q.shape)


def _deltas(kernel, device):
    return torch.tensor([[kx, ky, kz, 0] for kx in range(kernel[0])
                         for ky in range(kernel[1])
                         for kz in range(kernel[2])],
                        dtype=torch.int32, device=device)


def _unit_book(book_fn, out_table: SparseTensor, in_table: SparseTensor,
               kernel, stride):
    """``book_fn`` on each building of a unit, as the unit's flat book
    (ops/sparse.py): building u's entries + u * V_in, the pad B * V_in.
    These searched books serve the spatial shards and the API, one
    building a call; a unit's own pyramid takes its books from the
    downsample scatter."""
    nb, v_in = in_table.units, in_table.capacity
    books = [book_fn(out_table.building(u), in_table.building(u), kernel,
                     stride) for u in range(nb)]
    return torch.cat([torch.where(bk < v_in, bk + u * v_in, nb * v_in)
                      for u, bk in enumerate(books)], 1).to(torch.int32)


def conv_rulebook_match(out_table: SparseTensor, in_table: SparseTensor,
                        kernel, stride):
    """(K, V_out) strided-conv rulebook: entry [k, o] is the input row at
    out_coord(o) * stride + offset_k, V_in where absent (the contract of
    the JAX package's ops/sparse.conv_rulebook); a unit's flat book for
    stacked tables."""
    if out_table.batched:
        return _unit_book(conv_rulebook_match, out_table, in_table, kernel,
                          stride)
    st = torch.tensor([stride[0], stride[1], stride[2], 1],
                      dtype=torch.int32, device=out_table.device)
    q = (out_table.coords * st)[None] + _deltas(kernel, st.device)[:, None]
    qhi, qlo = pack_key(q, in_table.spatial_size,
                        valid=out_table.row_valid[None, :])
    return sorted_multi_match(qhi, qlo, qhi != INVALID, in_table)


def deconv_rulebook_match(fine_table: SparseTensor,
                          coarse_table: SparseTensor, kernel, stride):
    """(K, V_fine) deconv rulebook: entry [k, x] is the coarse row o with
    fine_coord(x) == o * stride + offset_k, V_coarse where absent (the
    contract of the JAX package's ops/sparse_conv.deconv_rulebook); a
    unit's flat book for stacked tables."""
    if fine_table.batched:
        return _unit_book(deconv_rulebook_match, fine_table, coarse_table,
                          kernel, stride)
    st = torch.tensor([stride[0], stride[1], stride[2], 1],
                      dtype=torch.int32, device=fine_table.device)
    num = fine_table.coords[None] - _deltas(kernel, st.device)[:, None]
    o = torch.div(num, st, rounding_mode="floor")
    exact = (o * st == num).all(-1)
    qhi, qlo = pack_key(o, coarse_table.spatial_size,
                        valid=fine_table.row_valid[None, :] & exact)
    return sorted_multi_match(qhi, qlo, qhi != INVALID, coarse_table)
