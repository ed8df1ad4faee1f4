"""Sparse convolution: gather-GEMM over rulebooks.

Counterpart of detection_3d_tpu/ops/sparse_conv.py. Every sparse conv
of the backbone (submanifold, strided, deconv, BEV) is

    out[i] = sum_k feats[idx[k, i]] @ W[k]

over a (K, V_out) int32 rulebook whose entry V_in reads a zero row, with
weights laid out (K, Cin, Cout), f32 sums, output rows with ``out_valid``
false zeroed, and the output in the feats dtype.

:func:`sparse_conv` launches the hand-written CUDA kernel
(csrc/gather_conv.cu) for tensors on the card and takes the plain
:func:`gather_conv` for tensors on the CPU.
"""

from __future__ import annotations

import torch

from detection_3d_tpu_torch.ops import cuda_lib


def gather_conv(feats, neighbor_idx, weights, out_valid):
    """Plain version: sum_k gather(feats, idx[k]) @ W[k] in f32.

    Args:
      feats: (V_in, Cin); neighbor_idx: (K, V_out) int32 (V_in => zero);
      weights: (K, Cin, Cout); out_valid: (V_out,) bool.
    Returns (V_out, Cout) in feats.dtype.
    """
    src = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))], 0)
    v_out = neighbor_idx.shape[1]
    out = torch.zeros((v_out, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for k in range(neighbor_idx.shape[0]):   # one (V_out, Cin) gather held
        rows = src[neighbor_idx[k].to(torch.int64)]
        out += rows.to(torch.float32) @ weights[k].to(torch.float32)
    out = torch.where(out_valid[:, None], out, 0.0)
    return out.to(feats.dtype)


_ENTRY = {torch.float32: "gather_conv_f32", torch.bfloat16: "gather_conv_bf16"}


def gather_conv_cuda(feats, neighbor_idx, weights, out_valid):
    """Kernel A on the card: same contract as :func:`gather_conv`."""
    v_in, cin = feats.shape
    n_off, v_out = neighbor_idx.shape
    cout = weights.shape[-1]
    dev = feats.device
    if feats.dtype not in _ENTRY or weights.dtype != feats.dtype:
        raise ValueError(f"gather_conv_cuda: feats {feats.dtype} / weights "
                         f"{weights.dtype}: expected both float32 or both "
                         "bfloat16")
    if (neighbor_idx.dtype != torch.int32 or out_valid.dtype != torch.bool
            or weights.shape != (n_off, cin, cout)
            or out_valid.shape != (v_out,)):
        raise ValueError("gather_conv_cuda: expected int32 idx (K, V_out), "
                         "weights (K, Cin, Cout) and bool out_valid (V_out,)")
    for t in (neighbor_idx, weights, out_valid):
        if t.device != dev:
            raise ValueError("gather_conv_cuda: inputs on different devices")
    feats, neighbor_idx, weights, out_valid = (
        t.contiguous() for t in (feats, neighbor_idx, weights, out_valid))
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


def sparse_conv(feats, neighbor_idx, weights, out_valid):
    """Kernel A for tensors on the card, the plain version on the CPU."""
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
