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
(csrc/multi_match.cu) for tensors on the card and takes the plain
:func:`multi_match_plain` (one ``searchsorted`` over the 64-bit
composite key, as kernel B's plain version) for tensors on the CPU. The
two are equal bit for bit. Unlike the TPU kernel, neither needs the
queries sorted.
"""

from __future__ import annotations

import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.coords import (
    INVALID, composite_key, key_search, pack_key,
)
from detection_3d_tpu_torch.ops.sparse import SparseTensor


def multi_match_plain(keys, queries):
    """Plain version: (N,) int64 composite queries -> (N,) int32 rows of
    the sorted (V,) int64 ``keys`` holding them, V where none does or the
    query is invalid (high half INVALID)."""
    idx, found = key_search(keys, queries >> 32, queries & 0xFFFFFFFF)
    return torch.where(found, idx, keys.shape[0]).to(torch.int32)


def multi_match_cuda(keys, queries):
    """Kernel D on the card: same contract as :func:`multi_match_plain`."""
    if (keys.dtype != torch.int64 or queries.dtype != torch.int64
            or keys.ndim != 1 or queries.ndim != 1
            or keys.device != queries.device):
        raise ValueError("multi_match_cuda: expected int64 (V,) keys and "
                         "(N,) queries on one device")
    keys, queries = keys.contiguous(), queries.contiguous()
    out = torch.empty(queries.shape, dtype=torch.int32, device=keys.device)
    if queries.numel() == 0:
        return out
    status = cuda_lib.library("multi_match").multi_match(
        keys.data_ptr(), queries.data_ptr(), out.data_ptr(),
        keys.shape[0], queries.shape[0], cuda_lib.stream_ptr(keys.device))
    cuda_lib.check("multi_match", status)
    cuda_lib.launches["multi_match"] += 1
    return out


def multi_match(keys, queries):
    """Kernel D for tensors on the card, the plain version on the CPU."""
    if keys.is_cuda:
        return multi_match_cuda(keys, queries)
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
