"""The collectives of the multi-device layer, with their gradients.

What ``jax.lax.psum``, ``all_gather`` and ``ppermute`` give the JAX
package (detection_3d_tpu/parallel/), over ``torch.distributed``. Each
differentiable collective is a ``torch.autograd.Function`` whose
backward is the collective's transpose:

  * :func:`all_reduce_sum` — the sum over the group; its backward is the
    same sum of the cotangents;
  * :func:`all_gather_rows` — equal-size payloads stacked in group-rank
    order along dim 0; its backward sums the cotangent over the group and
    keeps this rank's slice;
  * :func:`shift` — rank r receives rank r - offset's payload (zeros
    where there is no such rank; not periodic), as ``ppermute`` over
    ``[(i, i + offset)]``; its backward is the reverse shift.

All three rest on ``all_reduce`` and ``all_gather`` alone, which NCCL and
gloo both take on CUDA tensors (gloo also on the CPU). :func:`shift`
all-gathers and keeps the neighbour's slice, so it moves the group's
size times the bytes a point-to-point exchange would. bfloat16 payloads
are gathered as their bytes. ``group`` None is the default group.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_rank(group=None) -> int:
    return dist.get_rank(group)


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def _gather(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes), in group-rank order."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        return [p.bool() for p in _gather(x.to(torch.uint8), group)]
    bits = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
    parts = [torch.empty_like(bits) for _ in range(group_size(group))]
    dist.all_gather(parts, bits, group=group)
    if bits is not x:
        parts = [p.view(torch.bfloat16) for p in parts]
    return parts


def _reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _shift(x: torch.Tensor, offset: int, group=None) -> torch.Tensor:
    src = group_rank(group) - offset
    if not 0 <= src < group_size(group):
        _gather(x, group)          # every rank takes part in the gather
        return torch.zeros_like(x)
    return _gather(x, group)[src]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_sum(g, ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return torch.cat(_gather(x, group), 0)

    @staticmethod
    def backward(ctx, g):
        r, n = group_rank(ctx.group), ctx.rows
        return _reduce_sum(g, ctx.group)[r * n:(r + 1) * n], None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, group):
        ctx.offset, ctx.group = offset, group
        return _shift(x, offset, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.offset, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor); differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(size * N, ...): every rank's (N, ...) ``x`` stacked in group-rank
    order; differentiable. Integer and bool payloads too (no gradient)."""
    if not x.is_floating_point():
        return torch.cat(_gather(x, group), 0)
    return _AllGatherRows.apply(x, group)


def shift(x: torch.Tensor, offset: int, group=None) -> torch.Tensor:
    """Rank r gets rank (r - offset)'s ``x``, zeros where that rank does
    not exist; differentiable for floating payloads."""
    if not x.is_floating_point():
        return _shift(x, offset, group)
    return _Shift.apply(x, offset, group)
