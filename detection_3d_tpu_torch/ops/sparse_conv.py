"""Sparse convolution: gather-GEMM over rulebooks.

Counterpart of detection_3d_tpu/ops/sparse_conv.py. Every sparse conv
of the backbone (submanifold, strided, deconv, BEV) is

    out[i] = sum_k feats[idx[k, i]] @ W[k]

over a (K, V_out) int32 rulebook whose entry V_in reads a zero row, with
weights laid out (K, Cin, Cout), f32 sums, output rows with ``out_valid``
false zeroed, and the output in the feats dtype.

:func:`sparse_conv` launches the hand-written CUDA kernel
(csrc/gather_conv.cu) for tensors on the card and takes the plain
:func:`gather_conv` for tensors on the CPU. When a gradient is wanted it
goes through :class:`GatherConv`, whose backward launches the two kernels
of csrc/gather_conv_bwd.cu on the card and takes the plain
:func:`gather_conv_backward` on the CPU, so the CPU tests run the wiring
the card runs.
"""

from __future__ import annotations

import torch

from detection_3d_tpu_torch.ops import cuda_lib


def _acc_dtype(feats):
    """f32 sums for f32 and bf16 features (f64 for f64, which only the
    gradient checks use)."""
    return torch.promote_types(feats.dtype, torch.float32)


def gather_conv(feats, neighbor_idx, weights, out_valid):
    """Plain version: sum_k gather(feats, idx[k]) @ W[k] in f32.

    Args:
      feats: (V_in, Cin); neighbor_idx: (K, V_out) int32 (V_in => zero);
      weights: (K, Cin, Cout); out_valid: (V_out,) bool.
    Returns (V_out, Cout) in feats.dtype.
    """
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


_ENTRY = {torch.float32: "gather_conv_f32", torch.bfloat16: "gather_conv_bf16"}
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_conv_args(name, feats, neighbor_idx, weights, out_valid,
                     g=None):
    """Raise on what the kernels do not take; returns the inputs made
    contiguous (``g`` last, when given)."""
    v_in, cin = feats.shape
    n_off, v_out = neighbor_idx.shape
    cout = weights.shape[-1]
    dev = feats.device
    if feats.dtype not in _ENTRY or weights.dtype != feats.dtype or (
            g is not None and g.dtype != feats.dtype):
        raise ValueError(f"{name}: feats {feats.dtype} / weights "
                         f"{weights.dtype}: expected all float32 or all "
                         "bfloat16")
    if (neighbor_idx.dtype != torch.int32 or out_valid.dtype != torch.bool
            or weights.shape != (n_off, cin, cout)
            or out_valid.shape != (v_out,)
            or (g is not None and g.shape != (v_out, cout))):
        raise ValueError(f"{name}: expected int32 idx (K, V_out), weights "
                         "(K, Cin, Cout), bool out_valid (V_out,) and g "
                         "(V_out, Cout)")
    rest = (neighbor_idx, weights, out_valid) + (() if g is None else (g,))
    for t in rest:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
    return tuple(t.contiguous() for t in (feats,) + rest)


def gather_conv_cuda(feats, neighbor_idx, weights, out_valid):
    """Kernel A on the card: same contract as :func:`gather_conv`."""
    feats, neighbor_idx, weights, out_valid = _check_conv_args(
        "gather_conv_cuda", feats, neighbor_idx, weights, out_valid)
    v_in, cin = feats.shape
    n_off, v_out = neighbor_idx.shape
    cout = weights.shape[-1]
    dev = feats.device
    out = torch.empty((v_out, cout), dtype=feats.dtype, device=dev)
    if v_out == 0 or cout == 0:
        return out
    fn = getattr(cuda_lib.library("gather_conv"), _ENTRY[feats.dtype])
    status = fn(feats.data_ptr(), neighbor_idx.data_ptr(),
                weights.data_ptr(), out_valid.data_ptr(), out.data_ptr(),
                v_in, v_out, n_off, cin, cout, cuda_lib.stream_ptr(dev))
    cuda_lib.check("gather_conv", status)
    cuda_lib.launches["gather_conv"] += 1
    return out


def _scratch_and_out(shape, dtype, dev):
    """A zeroed f32 accumulator and the result it is cast into (the same
    tensor for f32)."""
    scratch = torch.zeros(shape, dtype=torch.float32, device=dev)
    if dtype == torch.float32:
        return scratch, scratch
    return scratch, torch.empty(shape, dtype=dtype, device=dev)


def gather_conv_dfeats_cuda(feats, neighbor_idx, weights, out_valid, g):
    """The dFeats kernel of csrc/gather_conv_bwd.cu: the first result of
    :func:`gather_conv_backward` (``feats`` gives only shape and type)."""
    feats, neighbor_idx, weights, out_valid, g = _check_conv_args(
        "gather_conv_dfeats_cuda", feats, neighbor_idx, weights, out_valid,
        g)
    v_in, cin = feats.shape
    n_off, v_out = neighbor_idx.shape
    scratch, out = _scratch_and_out((v_in, cin), feats.dtype, feats.device)
    if v_out == 0 or cin == 0 or v_in == 0:
        return out
    fn = getattr(cuda_lib.library("gather_conv_bwd"),
                 f"gather_conv_dfeats_{_DTYPE_TAG[feats.dtype]}")
    status = fn(g.data_ptr(), neighbor_idx.data_ptr(), weights.data_ptr(),
                out_valid.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                v_in, v_out, n_off, cin, weights.shape[-1],
                cuda_lib.stream_ptr(feats.device))
    cuda_lib.check("gather_conv_bwd", status)
    cuda_lib.launches["gather_conv_dfeats"] += 1
    return out


def gather_conv_dw_cuda(feats, neighbor_idx, weights, out_valid, g):
    """The dW kernel of csrc/gather_conv_bwd.cu: the second result of
    :func:`gather_conv_backward` (``weights`` gives only shape and
    type)."""
    feats, neighbor_idx, weights, out_valid, g = _check_conv_args(
        "gather_conv_dw_cuda", feats, neighbor_idx, weights, out_valid, g)
    v_in, cin = feats.shape
    n_off, v_out = neighbor_idx.shape
    cout = weights.shape[-1]
    scratch, out = _scratch_and_out((n_off, cin, cout), weights.dtype,
                                    feats.device)
    if v_out == 0 or cin == 0 or cout == 0:
        return out
    fn = getattr(cuda_lib.library("gather_conv_bwd"),
                 f"gather_conv_dw_{_DTYPE_TAG[feats.dtype]}")
    status = fn(feats.data_ptr(), g.data_ptr(), neighbor_idx.data_ptr(),
                out_valid.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                v_in, v_out, n_off, cin, cout,
                cuda_lib.stream_ptr(feats.device))
    cuda_lib.check("gather_conv_bwd", status)
    cuda_lib.launches["gather_conv_dw"] += 1
    return out


class GatherConv(torch.autograd.Function):
    """Sparse conv with its gradient: kernel A forward and the two
    backward kernels on the card; :func:`gather_conv` and
    :func:`gather_conv_backward` on the CPU. The index and mask get no
    gradient."""

    @staticmethod
    def forward(ctx, feats, neighbor_idx, weights, out_valid):
        ctx.save_for_backward(feats, neighbor_idx, weights, out_valid)
        if feats.is_cuda:
            return gather_conv_cuda(feats, neighbor_idx, weights, out_valid)
        return gather_conv(feats, neighbor_idx, weights, out_valid)

    @staticmethod
    def backward(ctx, g):
        feats, idx, weights, valid = ctx.saved_tensors
        need_feats, _, need_w, _ = ctx.needs_input_grad
        if not g.is_cuda:
            d_feats, d_w = gather_conv_backward(feats, idx, weights, valid,
                                                g)
            return (d_feats if need_feats else None, None,
                    d_w if need_w else None, None)
        d_feats = d_w = None
        if need_feats:
            d_feats = gather_conv_dfeats_cuda(feats, idx, weights, valid, g)
        if need_w:
            d_w = gather_conv_dw_cuda(feats, idx, weights, valid, g)
        return d_feats, None, d_w, None


def sparse_conv(feats, neighbor_idx, weights, out_valid):
    """Kernel A for tensors on the card, the plain version on the CPU;
    through :class:`GatherConv` when a gradient is wanted."""
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weights.requires_grad):
        return GatherConv.apply(feats, neighbor_idx, weights, out_valid)
    if feats.is_cuda:
        return gather_conv_cuda(feats, neighbor_idx, weights, out_valid)
    return gather_conv(feats, neighbor_idx, weights, out_valid)


def submanifold_conv(table_feats, neighbor_idx, weights, out_valid):
    """Submanifold conv: output sites == input sites (27-offset book)."""
    return sparse_conv(table_feats, neighbor_idx, weights, out_valid)


def strided_conv(in_feats, rulebook_idx, weights, out_valid):
    """Strided (downsampling) or z-collapsing BEV conv over its book."""
    return sparse_conv(in_feats, rulebook_idx, weights, out_valid)


def deconv(in_feats, rulebook_idx, weights, out_valid):
    """Transposed conv back onto a finer table: ``rulebook_idx`` (K,
    V_fine) indexes the coarse table (the reversed strided book)."""
    return sparse_conv(in_feats, rulebook_idx, weights, out_valid)


def nin_conv(feats, weight, out_valid):
    """1x1x1 (NetworkInNetwork) conv: one plain matmul over the rows."""
    out = feats @ weight
    return torch.where(out_valid[:, None], out, 0.0).to(feats.dtype)
