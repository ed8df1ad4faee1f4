"""The masked BN's closed-form backward and the autograd Function's
wiring, on the CPU (ops/norm.py).

The card's backward kernels (csrc/masked_bn.cu) follow the closed form
:func:`batch_norm_leaky_relu_backward_plain`; here it is held against
autograd through the plain forward in float64, where the two differ by
rounding alone (atol 1e-9 of the largest gradient): a leaky, a ReLU and
a BN-alone slope, one building and a unit, the clamp's tie (s2 / n -
mean^2 exactly 0: half the variance's gradient) and a cancelled
variance below 0 (none of it), each with eps so small that the
variance's term leads dx (rtol 1e-6 there: autograd's own path, 2 x
ds2 - 2 mean ds2, cancels 31 bits; a wrong share is off by 2x or
more); a building without valid rows; and a process
group of one (a spawned gloo rank). The kernels' plain twins chained as
the card chains the kernels (statistics, normalise; the backward's sums,
dx) give the plain version's output bits and its gradients within
float32's rounding (one bf16 step of the largest in bf16); on the CPU
:func:`batch_norm_leaky_relu` is the plain version and launches nothing,
and :class:`MaskedBatchNorm` refuses CPU tensors.
"""

import numpy as np
import pytest
import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.norm import (
    BN_CHUNKS, BN_MIN_CHUNK, MaskedBatchNorm, batch_norm_leaky_relu,
    batch_norm_leaky_relu_backward_plain, batch_norm_leaky_relu_plain,
    chunk_rows, masked_grad_apply, masked_grad_sums, masked_sums, moments,
    normalise_plain)
from detection_3d_tpu_torch.parallel.checks import masked_bn_group_job
from detection_3d_tpu_torch.parallel.mesh import launch


def _case(name):
    """(feats, valid, scale, bias, cotangent, leakiness, eps) in float64;
    for the tie and the cancelled variance, channel 0's valid rows are
    [1, 1 + 2^-30] and [1, 1, 1 + 2^-29]."""
    rng = np.random.RandomState(sum(map(ord, name)))
    lead, v, c, leak, eps = {
        "relu": ((), 37, 5, 0.0, 1e-4),
        "leaky_unit": ((3,), 41, 6, 0.2, 1e-4),
        "bn_alone": ((2,), 29, 7, 1.0, 1e-5),
        "tie": ((), 6, 3, 0.0, 1e-30),
        "negative_variance": ((), 6, 3, 0.0, 1e-30),
        "no_valid_rows": ((), 9, 4, 0.0, 1e-4),
        "process_group_of_one": ((), 33, 5, 0.0, 1e-5),
    }[name]
    feats = rng.randn(*lead, v, c) * 2 + 1
    valid = rng.rand(*lead, v) < 0.7
    if name in ("tie", "negative_variance"):
        col = ([1.0, 1 + 2.0 ** -30] if name == "tie"
               else [1.0, 1.0, 1 + 2.0 ** -29])
        valid[:] = False
        valid[:len(col)] = True
        feats[:len(col), 0] = col
    if name == "no_valid_rows":
        valid[:] = False
    scale = rng.rand(c) + 0.5
    bias = rng.randn(c)
    cot = rng.randn(*lead, v, c)
    return feats, valid, scale, bias, cot, leak, eps


def _close(got, want, rtol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("name", [
    "relu", "leaky_unit", "bn_alone", "tie", "negative_variance",
    "no_valid_rows", "process_group_of_one"])
def test_closed_form_backward_matches_autograd(name, tmp_path):
    feats, valid, scale, bias, cot, leak, eps = _case(name)
    if name == "process_group_of_one":
        (res,) = launch(masked_bn_group_job, 1, "gloo",
                        str(tmp_path / "init"),
                        args=([feats], [valid], scale, bias, [cot], leak,
                              eps))
        want, got = res["plain"], res["closed"]
        assert "function" not in res        # the kernels: the card's test
        got = (got["d_feats"], got["d_scale"], got["d_bias"])
        want = (want["d_feats"], want["d_scale"], want["d_bias"])
    else:
        x, s, b, ct = (torch.from_numpy(a) for a in (feats, scale, bias,
                                                     cot))
        v = torch.from_numpy(valid)
        share = moments(masked_sums(x, v), eps, half=True)[3]
        if name == "tie":
            assert share[..., 0].item() == 0.5
        if name == "negative_variance":
            assert share[..., 0].item() == 0.0
        xs, ss, bs = (t.clone().requires_grad_() for t in (x, s, b))
        y = batch_norm_leaky_relu_plain(xs, v, ss, bs, leak, eps)
        want = torch.autograd.grad((y * ct).sum(), (xs, ss, bs))
        got = batch_norm_leaky_relu_backward_plain(ct, x, v, s, b, leak, eps)
        if name == "no_valid_rows":
            assert not y.any() and not any(g.any() for g in got)
    rtol = 1e-6 if name in ("tie", "negative_variance") else 1e-9
    for g, w in zip(got, want):
        _close(g, w, rtol)


@pytest.mark.parametrize("leak", [0.0, 1.0])
@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_twins_match_plain_autograd(dtype, lead, leak):
    rng = np.random.RandomState(7)
    v, c = 50, 12
    x = torch.from_numpy(rng.randn(*lead, v, c) * 3 + 1).to(dtype)
    valid = torch.from_numpy(rng.rand(*lead, v) < 0.6)
    scale = torch.from_numpy(rng.rand(c) + 0.5).float()
    bias = torch.from_numpy(rng.randn(c)).float()
    ct = torch.from_numpy(rng.randn(*lead, v, c)).to(dtype)
    before = dict(cuda_lib.launches)
    res = []
    for fn in (batch_norm_leaky_relu_plain, batch_norm_leaky_relu):
        xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
        y = fn(xs, valid, ss, bs, leak, 1e-4, None)
        res.append((y,) + torch.autograd.grad((y.float() * ct.float()).sum(),
                                              (xs, ss, bs)))
    assert cuda_lib.launches == before     # no kernel on the CPU
    (want, *wgrads), (cpu, *cgrads) = res
    assert torch.equal(cpu, want)
    for g, w in zip(cgrads, wgrads):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        MaskedBatchNorm.apply(x, valid, scale, bias, leak, 1e-4, None)

    # the twins chained as MaskedBatchNorm chains the kernels
    lead_shape = x.shape
    xr, vr = x.reshape(-1, v, c), valid.reshape(-1, v)
    sums = masked_sums(xr, vr)
    got = normalise_plain(xr, vr, sums, scale, bias, leak,
                          1e-4).reshape(lead_shape)
    dz = ct.reshape(xr.shape)
    gsums = masked_grad_sums(xr, dz, vr, sums, scale, bias, leak, 1e-4)
    total = gsums.sum(0)
    dx = masked_grad_apply(xr, dz, vr, sums, gsums, scale, bias, leak, 1e-4)
    grads = (dx.reshape(lead_shape), total[c:], total[:c])
    assert got.dtype == dtype and torch.equal(got, want)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for g, w in zip(grads, wgrads):
        assert g.dtype == w.dtype
        err = (g.double() - w.double()).abs().max().item()
        assert err <= tol * w.double().abs().max().item(), err


@pytest.mark.parametrize("v", [0, 1, 4000, 65536, 524288, 2_000_000])
def test_chunk_rows_bounds(v):
    """The statistics' chunks: a multiple of 64 rows, at least
    BN_MIN_CHUNK, at most BN_CHUNKS of them."""
    rows = chunk_rows(v)
    assert rows % 64 == 0 and rows >= BN_MIN_CHUNK
    assert -(-v // rows) <= BN_CHUNKS
