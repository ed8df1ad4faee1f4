"""Masked batch norm + leaky ReLU over active sparse rows.

Counterpart of detection_3d_tpu/ops/norm.py. The reference configs run
TRACK_RUNNING_STATS=False, so batch statistics are used in eval too;
statistics are taken over valid rows only, eps is 1e-4, and invalid rows
come out zero. A unit of B buildings (feats (B, V, C)) normalises each
building with its own statistics, as a vmap over buildings does. The
sums over the rows run in a fixed order, so a building's statistics are
the same bits in a unit as alone. With a ``process_group`` (a voxel set spatially sharded
over ranks, parallel/spatial.py) the row count and the two moment sums
are summed over the group first, so every shard normalises with the
global statistics (JAX's ``axis_name`` psum).

On the card :func:`batch_norm_leaky_relu` runs csrc/masked_bn.cu through
:class:`MaskedBatchNorm`: a statistics pass and a normalise pass forward,
a reduce pass and an apply pass backward (the all-reduce, with a group,
between the two passes of each). On the CPU it runs the plain version
(:func:`batch_norm_leaky_relu_plain`) under autograd. Each kernel has
its plain twin here, which the tests hold it against
(:func:`masked_sums`, :func:`normalise_plain`, :func:`masked_grad_sums`,
:func:`masked_grad_apply`), and
:func:`batch_norm_leaky_relu_backward_plain` is the closed-form backward
they make together.
"""

from __future__ import annotations

import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.parallel.collectives import all_reduce_sum


ROWS_CHUNK = 16
# the card's first stage sums chunks of rows (csrc/masked_bn.cu): at most
# BN_CHUNKS a leading index, at least BN_MIN_CHUNK rows each
BN_CHUNKS = 512
BN_MIN_CHUNK = 256
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_VEC = {torch.float32: 4, torch.bfloat16: 8}


def rows_sum(x):
    """Sum of (..., V, C) over its V rows in a fixed tree: chunks of
    ROWS_CHUNK consecutive rows (zero-padded), then chunks of those
    sums, until one is left. Each leading index takes the same order
    whatever the leading shape is; one reduction over a (B, V, C) tensor
    splits its V rows among the card's blocks by the number of outputs,
    so a building's sums would change bits with B."""
    while x.shape[-2] > 1:
        pad = (-x.shape[-2]) % ROWS_CHUNK
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-2]
                                          + (pad, x.shape[-1]))], -2)
        x = x.reshape(x.shape[:-2] + (-1, ROWS_CHUNK, x.shape[-1])).sum(-2)
    return x[..., 0, :]


def _work(feats):
    """The statistics' type: float32, or float64 for float64 rows (the
    closed form's tests)."""
    return torch.promote_types(feats.dtype, torch.float32)


def _sums(f32, valid):
    w = valid.to(f32.dtype)[..., None]
    return rows_sum(torch.cat([w, f32 * w, f32.square() * w], -1))


def masked_sums(feats, valid):
    """(..., 2C + 1): each leading index's valid-row count, sum x and sum
    x^2 over its (V, C) rows (the statistics kernel's plain twin)."""
    return _sums(feats.to(_work(feats)), valid)


def moments(sums, eps, half: bool = False):
    """(n, mean, inv) from ``sums`` (..., 2C + 1): n clamped at 1, the
    variance s2 / n - mean^2 clamped at 0, inv = 1 / sqrt(var + eps);
    n is (..., 1), the others (..., C). With ``half`` also the share of
    the variance's gradient that the clamp passes: 1 above 0, 1/2 at 0,
    0 below (torch.maximum's rule)."""
    c = (sums.shape[-1] - 1) // 2
    n = torch.clamp(sums[..., :1], min=1.0)
    mean = sums[..., 1:1 + c] / n
    var = sums[..., 1 + c:] / n - mean.square()
    # torch.maximum: at a tie its gradient splits in halves, as
    # jnp.maximum's does (clamp would pass all of it)
    clamped = torch.maximum(var, torch.zeros_like(var))
    inv = torch.reciprocal(torch.sqrt(clamped + eps))
    if not half:
        return n, mean, inv
    share = torch.where(var < 0, 0.0, torch.where(var == 0, 0.5, 1.0))
    return n, mean, inv, share.to(var.dtype)


def _normalise(f32, valid, sums, scale, bias, leakiness, eps):
    _, mean, inv = moments(sums, eps)
    out = (f32 - mean[..., None, :]) * (inv * scale)[..., None, :] + bias
    if leakiness != 1.0:    # slope 1: BN alone
        out = torch.where(out > 0, out, out * leakiness)
    return torch.where(valid[..., None], out, 0.0)


def normalise_plain(feats, valid, sums, scale, bias, leakiness: float = 0.0,
                    eps: float = 1e-4):
    """The normalise kernel's plain twin: (x - mean) * (inv * scale) +
    bias from ``sums`` (:func:`masked_sums`), the leaky slope, zero on
    invalid rows, in feats.dtype."""
    return _normalise(feats.to(_work(feats)), valid, sums, scale, bias,
                      leakiness, eps).to(feats.dtype)


def batch_norm_leaky_relu_plain(feats, valid, scale, bias,
                                leakiness: float = 0.0, eps: float = 1e-4,
                                process_group=None):
    """The plain version (the CPU path; autograd gives its gradient):
    feats (..., V, C); valid (..., V) bool; scale/bias (C,). Statistics
    over each leading index's V rows; they and the normalisation run in
    f32; the output is in feats.dtype. ``process_group`` (one building's
    (V, C) rows): sum (n, sum x, sum x^2) over its ranks (a
    differentiable all-reduce) before the moments are taken."""
    f32 = feats.to(_work(feats))
    sums = _sums(f32, valid)
    if process_group is not None:
        sums = all_reduce_sum(sums, process_group)
    return _normalise(f32, valid, sums, scale, bias, leakiness,
                      eps).to(feats.dtype)


def _dy_xhat(feats, dout, valid, sums, scale, bias, leakiness, eps):
    f32 = feats.to(_work(feats))
    g = dout.to(f32.dtype)
    _, mean, inv = moments(sums, eps)
    xc = f32 - mean[..., None, :]
    y = xc * (inv * scale)[..., None, :] + bias
    dy = torch.where(y > 0, g, g * leakiness) if leakiness != 1.0 else g
    return torch.where(valid[..., None], dy, 0.0), xc * inv[..., None, :]


def masked_grad_sums(feats, dout, valid, sums, scale, bias,
                     leakiness: float = 0.0, eps: float = 1e-4):
    """The backward reduce kernel's plain twin: (..., 2C), each leading
    index's sum of dy and of dy * xhat over its valid rows, dy the
    output's gradient ``dout`` through the slope, xhat = (x - mean) *
    inv."""
    dy, xhat = _dy_xhat(feats, dout, valid, sums, scale, bias, leakiness,
                        eps)
    return rows_sum(torch.cat([dy, dy * xhat], -1))


def masked_grad_apply(feats, dout, valid, sums, gsums, scale, bias,
                      leakiness: float = 0.0, eps: float = 1e-4):
    """The backward apply kernel's plain twin: dx = scale * inv / n *
    (n dy - sum dy - half * xhat * sum(dy xhat)) on valid rows, 0
    elsewhere, in feats.dtype; ``gsums`` from :func:`masked_grad_sums`
    (summed over the group, with one)."""
    dy, xhat = _dy_xhat(feats, dout, valid, sums, scale, bias, leakiness,
                        eps)
    n, _, inv, half = moments(sums, eps, half=True)
    c = feats.shape[-1]
    coef = (scale * inv / n)[..., None, :]
    dx = coef * (n[..., None, :] * dy - gsums[..., None, :c]
                 - half[..., None, :] * xhat * gsums[..., None, c:])
    return torch.where(valid[..., None], dx, 0.0).to(feats.dtype)


def batch_norm_leaky_relu_backward_plain(dout, feats, valid, scale, bias,
                                         leakiness: float = 0.0,
                                         eps: float = 1e-4,
                                         process_group=None):
    """The closed-form backward of :func:`batch_norm_leaky_relu_plain`,
    the arithmetic the card's backward kernels follow: (d_feats, d_scale,
    d_bias). With ``process_group`` the statistics' sums and the two
    gradient sums are summed over the group; the parameters' gradients
    are this rank's part."""
    sums = masked_sums(feats, valid)
    if process_group is not None:
        sums = all_reduce_sum(sums, process_group)
    gsums = masked_grad_sums(feats, dout, valid, sums, scale, bias,
                             leakiness, eps)
    c = feats.shape[-1]
    total = gsums.reshape(-1, 2 * c).sum(0)
    if process_group is not None:
        gsums = all_reduce_sum(gsums, process_group)
    d_feats = masked_grad_apply(feats, dout, valid, sums, gsums, scale,
                                bias, leakiness, eps)
    return d_feats, total[c:], total[:c]


# ---- the card's kernels (csrc/masked_bn.cu) --------------------------------

def chunk_rows(v: int) -> int:
    """Rows a block of the first stage sums: at most BN_CHUNKS chunks,
    at least BN_MIN_CHUNK rows, a multiple of 64. It depends on V alone,
    so a building's sums take one order alone and in a unit."""
    rows = max(BN_MIN_CHUNK, -(-v // BN_CHUNKS))
    return -(-rows // 64) * 64


def _vec(c, dtype, *rows) -> int:
    """1 when the kernels may take 16-byte accesses: C a multiple of the
    vector width and every row tensor 16-byte aligned."""
    return int(c % _VEC[dtype] == 0
               and all(t.data_ptr() % 16 == 0 for t in rows))


def _check(name, x, valid, *more):
    if not x.is_cuda:
        raise ValueError(f"{name}: rows on {x.device}: the kernels take "
                         "CUDA tensors")
    if x.dtype not in _DTYPE_TAG:
        raise ValueError(f"{name}: rows {x.dtype}: expected float32 or "
                         "bfloat16")
    if x.dim() != 3 or valid.shape != x.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f"{name}: expected rows (B, V, C) and a bool mask "
                         f"(B, V); got {tuple(x.shape)} and "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if x.shape[0] > 65535:
        raise ValueError(f"{name}: {x.shape[0]} leading indices; at most "
                         "65535")
    for t in (valid,) + more:
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t is not valid and not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous inputs")
    for t in more:
        if t.dtype != x.dtype and t.dtype != torch.float32:
            raise ValueError(f"{name}: {t.dtype} beside {x.dtype} rows: "
                             "expected the rows' type, or float32 "
                             "statistics and parameters")


def _fn(role, dtype):
    return getattr(cuda_lib.library("masked_bn"),
                   f"masked_bn_{role}_{_DTYPE_TAG[dtype]}")


def masked_sums_cuda(x, valid):
    """The statistics kernel (and its fold): x (B, V, C) contiguous,
    valid (B, V) bool -> sums (B, 2C + 1) float32, as
    :func:`masked_sums`."""
    _check("masked_sums_cuda", x, valid)
    b, v, c = x.shape
    chunk = chunk_rows(v)
    j = -(-v // chunk)
    part = torch.empty((b, j, 2 * c + 1), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((b, 2 * c + 1), dtype=torch.float32, device=x.device)
    status = _fn("stats", x.dtype)(
        x.data_ptr(), valid.data_ptr(), part.data_ptr(), sums.data_ptr(), b,
        v, c, chunk, j, _vec(c, x.dtype, x), cuda_lib.stream_ptr(x.device))
    cuda_lib.check("masked_bn", status)
    cuda_lib.launches["masked_bn_stats"] += 1
    return sums


def normalise_cuda(x, valid, sums, scale, bias, leakiness, eps):
    """The normalise kernel: as :func:`normalise_plain`, x (B, V, C)
    contiguous, scale and bias (C,) float32."""
    _check("normalise_cuda", x, valid, sums, scale, bias)
    out = torch.empty_like(x)
    b, v, c = x.shape
    status = _fn("normalise", x.dtype)(
        x.data_ptr(), valid.data_ptr(), sums.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, v, c, _vec(c, x.dtype, x, out),
        leakiness, eps, cuda_lib.stream_ptr(x.device))
    cuda_lib.check("masked_bn", status)
    cuda_lib.launches["masked_bn_normalise"] += 1
    return out


def masked_grad_sums_cuda(x, dz, valid, sums, scale, bias, leakiness, eps):
    """The backward reduce kernel (and its fold): (gsums (B, 2C), their
    sum over B (2C,)), as :func:`masked_grad_sums`."""
    _check("masked_grad_sums_cuda", x, valid, dz, sums, scale, bias)
    b, v, c = x.shape
    chunk = chunk_rows(v)
    j = -(-v // chunk)
    part = torch.empty((b, j, 2 * c), dtype=torch.float32, device=x.device)
    gsums = torch.empty((b, 2 * c), dtype=torch.float32, device=x.device)
    total = torch.empty((2 * c,), dtype=torch.float32, device=x.device)
    status = _fn("dsums", x.dtype)(
        x.data_ptr(), dz.data_ptr(), valid.data_ptr(), sums.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), part.data_ptr(), gsums.data_ptr(),
        total.data_ptr(), b, v, c, chunk, j, _vec(c, x.dtype, x, dz),
        leakiness, eps, cuda_lib.stream_ptr(x.device))
    cuda_lib.check("masked_bn", status)
    cuda_lib.launches["masked_bn_dsums"] += 1
    return gsums, total


def masked_grad_apply_cuda(x, dz, valid, sums, gsums, scale, bias, leakiness,
                           eps):
    """The backward apply kernel: dx as :func:`masked_grad_apply`."""
    _check("masked_grad_apply_cuda", x, valid, dz, sums, gsums, scale, bias)
    dx = torch.empty_like(x)
    b, v, c = x.shape
    status = _fn("dx", x.dtype)(
        x.data_ptr(), dz.data_ptr(), valid.data_ptr(), sums.data_ptr(),
        gsums.data_ptr(), scale.data_ptr(), bias.data_ptr(), dx.data_ptr(),
        b, v, c, _vec(c, x.dtype, x, dz, dx), leakiness, eps,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check("masked_bn", status)
    cuda_lib.launches["masked_bn_dx"] += 1
    return dx


def _rows(feats, valid):
    """feats (..., V, C) and valid (..., V) as contiguous (B, V, C) and
    (B, V)."""
    v, c = feats.shape[-2:]
    return (feats.reshape((-1, v, c)).contiguous(),
            valid.reshape((-1, v)).contiguous())


class MaskedBatchNorm(torch.autograd.Function):
    """Masked BN + leaky ReLU on the card, with its closed-form backward:
    the kernels of csrc/masked_bn.cu (CUDA tensors only; the CPU runs
    :func:`batch_norm_leaky_relu_plain`). Saves the rows, the mask and
    the statistics' sums (no float32 copy of the rows)."""

    @staticmethod
    def forward(ctx, feats, valid, scale, bias, leakiness, eps,
                process_group):
        x, m = _rows(feats, valid)
        s32 = scale.to(_work(feats)).contiguous()
        b32 = bias.to(_work(feats)).contiguous()
        sums = masked_sums_cuda(x, m)
        if process_group is not None:
            sums = all_reduce_sum(sums, process_group)
        out = normalise_cuda(x, m, sums, s32, b32, leakiness, eps)
        ctx.save_for_backward(x, m, sums, s32, b32)
        ctx.meta = (leakiness, eps, process_group, feats.shape,
                    scale.dtype, bias.dtype)
        return out.reshape(feats.shape)

    @staticmethod
    def backward(ctx, dout):
        x, m, sums, s32, b32 = ctx.saved_tensors
        leakiness, eps, group, shape, s_dtype, b_dtype = ctx.meta
        dz = dout.reshape(x.shape).to(x.dtype).contiguous()
        c = x.shape[-1]
        gsums, total = masked_grad_sums_cuda(x, dz, m, sums, s32, b32,
                                             leakiness, eps)
        d_feats = None
        if ctx.needs_input_grad[0]:
            if group is not None:
                gsums = all_reduce_sum(gsums, group)
            d_feats = masked_grad_apply_cuda(
                x, dz, m, sums, gsums, s32, b32, leakiness,
                eps).reshape(shape)
        elif group is not None:
            all_reduce_sum(gsums, group)    # every rank takes part
        return (d_feats, None, total[c:].to(s_dtype),
                total[:c].to(b_dtype), None, None, None)


def batch_norm_leaky_relu(feats, valid, scale, bias, leakiness: float = 0.0,
                          eps: float = 1e-4, process_group=None):
    """feats (..., V, C); valid (..., V) bool; scale/bias (C,). Statistics
    over each leading index's V rows, in f32; the output is in
    feats.dtype. ``process_group`` (one building's (V, C) rows): sum (n,
    sum x, sum x^2) over its ranks before the moments are taken, and the
    backward's two sums before dx. CUDA tensors run csrc/masked_bn.cu
    (float32 or bfloat16 rows, else it raises); CPU tensors the plain
    version."""
    if not feats.is_cuda:
        return batch_norm_leaky_relu_plain(feats, valid, scale, bias,
                                           leakiness, eps, process_group)
    if feats.shape[-1] == 0 or feats.numel() == 0 and process_group is None:
        return feats.clone()
    return MaskedBatchNorm.apply(feats, valid, scale, bias, float(leakiness),
                                 float(eps), process_group)


def batch_stats(feats, valid):
    """Masked (mean, var) over the valid rows, f32, for keeping running
    statistics (JAX ops/norm.py:51); the variance is taken about the
    mean, as JAX takes it."""
    f32 = feats.to(torch.float32)
    w = valid.to(torch.float32)[:, None]
    n = torch.clamp(w.sum(), min=1.0)
    mean = (f32 * w).sum(0) / n
    var = ((f32 - mean).square() * w).sum(0) / n
    return mean, var
