"""The generic sparse networks (detection_3d_tpu_torch/models/factories.py)
against the JAX package's (models/factories.py), on the CPU.

One plan of JAX's own fixture (tests/test_factories.py: 400 voxels on a
48 x 48 x 16 grid, 6 channels, levels of 512, 256 and 128 rows) is built
by both packages; each network is initialised by JAX and its parameter
tree loaded into the port through utils/convert.convert_jax_params and
``load_state_dict(strict=True)``.

Tolerances: plan_levels' tables and books bit exact; outputs within
1e-4 (f32 sums in another order through BN); gradients of
``(out ** 2).sum()`` within atol 1e-5 + rtol 1e-3 of JAX's, as
tests/test_torch_train_step.py holds the detector's. Dropout's draws
are the port's own (torch.bernoulli), so it is held to its contract:
the identity when deterministic or at rate 0, kept entries scaled by
exactly 1 / (1 - rate), invalid rows untouched, and the dropped share
near the rate.
"""

import numpy as np
import jax
import pytest
import torch

from detection_3d_tpu.models import factories as jfac
from detection_3d_tpu_torch.models import factories as tfac
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from test_torch_common import table_pair, to_numpy_tree

CAPS = (512, 256, 128)
SPATIAL = (48, 48, 16)
IN_CH = 6
VGG_LAYERS = (("C", 8), ("C", 8), ("MP",), ("C", 16), ("C3/2", 24))

# name -> (JAX module, port module)
NETS = {
    "unet": (lambda: jfac.SparseUNet(nplanes=(8, 16, 24), reps=1),
             lambda: tfac.SparseUNet(IN_CH, (8, 16, 24), reps=1)),
    "unet_residual_leaky": (
        lambda: jfac.SparseUNet(nplanes=(8, 16), reps=2, residual=True,
                                leakiness=0.1),
        lambda: tfac.SparseUNet(IN_CH, (8, 16), reps=2, residual=True,
                                leakiness=0.1)),
    "vgg": (lambda: jfac.SparseVGG(layers=VGG_LAYERS, leakiness=0.2),
            lambda: tfac.SparseVGG(IN_CH, VGG_LAYERS, leakiness=0.2)),
    "fcn": (lambda: jfac.FullyConvolutionalNet(nplanes=(8, 16, 24), reps=1),
            lambda: tfac.FullyConvolutionalNet(IN_CH, (8, 16, 24), reps=1)),
}


def _inputs():
    rng = np.random.RandomState(0)
    coords = np.concatenate(
        [rng.randint(0, (48, 48, 16, 1), (300, 4)),
         rng.randint(0, (48, 48, 16, 1), (100, 4))]).astype(np.int32)
    feats = rng.randn(400, IN_CH).astype(np.float32)
    return coords, feats


@pytest.fixture(scope="module")
def plans():
    """(JAX plan, port plan with backward books) of one table."""
    coords, feats = _inputs()
    jt, tt = table_pair(coords, feats, SPATIAL, CAPS[0])
    return (jfac.plan_levels(jt, CAPS),
            tfac.plan_levels(tt, CAPS, backward=True))


def _out(o):
    """A network's features (SparseVGG returns (features, level))."""
    return o[0] if isinstance(o, tuple) else o


@pytest.fixture(scope="module")
def jax_runs(plans):
    """Per network: JAX's parameters, output and parameter gradients."""
    jplan, _ = plans
    runs = {}
    for i, (name, (jnet, _)) in enumerate(NETS.items()):
        net = jnet()
        params = net.init(jax.random.PRNGKey(i), jplan)

        def loss(p, net=net):
            out = _out(net.apply(p, jplan))
            return (out ** 2).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
        runs[name] = (to_numpy_tree(params), np.asarray(out),
                      convert_jax_params(to_numpy_tree(grads)))
    return runs


def _port_net(name, params):
    net = NETS[name][1]()
    net.load_state_dict(convert_jax_params(params), strict=True)
    return net


@pytest.mark.parametrize("field", ["tables", "subm_idx", "down_rb",
                                   "up_rb"])
def test_plan_levels_bit_exact(plans, field):
    jplan, tplan = plans
    assert len(tplan[field]) == len(jplan[field])
    for j, t in zip(jplan[field], tplan[field]):
        if field == "tables":
            for attr in ("coords", "hi", "lo", "feats"):
                np.testing.assert_array_equal(getattr(t, attr).numpy(),
                                              np.asarray(getattr(j, attr)))
            assert int(t.num) == int(j.num) and t.capacity == j.capacity
        else:
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_plan_levels_orders_and_books(plans):
    """Every book has its row order, and with ``backward`` its
    BackwardBook, as the detector's pyramid has them."""
    from detection_3d_tpu_torch.ops.sparse_conv import (
        backward_book, rulebook_row_order)
    _, tplan = plans
    tables = tplan["tables"]
    for k, idx in enumerate(tplan["subm_idx"]):
        want = rulebook_row_order(idx, tables[k].capacity,
                                  tables[k].row_valid)
        assert torch.equal(tplan["subm_order"][k].masks, want.masks)
    for k, rb in enumerate(tplan["up_rb"]):      # level k + 1 -> level k
        assert rb.shape == (8, tables[k].capacity)
        want = backward_book(rb, tables[k + 1].capacity, tables[k].row_valid)
        got = tplan["up_bwd"][k]
        assert torch.equal(got.entries, want.entries)
        assert torch.equal(got.starts, want.starts)
    assert "subm_bwd" not in tfac.plan_levels(tables[0], CAPS)


@pytest.mark.parametrize("name", list(NETS))
def test_forward_matches_jax(plans, jax_runs, name):
    _, tplan = plans
    params, want, _ = jax_runs[name]
    with torch.no_grad():
        got = _out(_port_net(name, params)(tplan))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    rv = tplan["tables"][0].row_valid.numpy()
    if name != "vgg":
        assert np.abs(got.numpy()[rv]).sum() > 0


@pytest.mark.parametrize("name", list(NETS))
def test_gradients_match_jax(plans, jax_runs, name):
    _, tplan = plans
    params, _, want = jax_runs[name]
    net = _port_net(name, params)
    (_out(net(tplan)) ** 2).sum().backward()
    got = {k: p.grad for k, p in net.named_parameters()}
    assert set(got) == set(want)
    for k, g in want.items():
        assert got[k] is not None, k
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_vgg_levels_and_rejects_unknown_entry(plans):
    _, tplan = plans
    out, lvl = tfac.SparseVGG(IN_CH, VGG_LAYERS)(tplan)
    assert lvl == 2 and out.shape == (CAPS[2], 24)
    with pytest.raises(ValueError):
        tfac.SparseVGG(IN_CH, (("XX", 8),))


def test_unet_needs_enough_levels(plans):
    _, tplan = plans
    with pytest.raises(ValueError):
        tfac.SparseUNet(IN_CH, (8, 16, 24, 32))(tplan)


def test_dropout_contract():
    feats = torch.from_numpy(
        np.random.RandomState(0).randn(4000, 8).astype(np.float32))
    valid = torch.arange(4000) < 3000
    drop = tfac.SparseDropout(rate=0.25)
    assert drop(feats, valid, deterministic=True) is feats
    assert tfac.SparseDropout(0.0)(feats, valid, deterministic=False) \
        is feats
    gen = torch.Generator().manual_seed(7)
    out = drop(feats, valid, deterministic=False, generator=gen)
    o, f = out.numpy(), feats.numpy()
    zeroed = o[:3000] == 0
    assert abs(zeroed.mean() - 0.25) < 0.02
    kept = ~zeroed
    np.testing.assert_array_equal(o[:3000][kept],
                                  (f[:3000] / np.float32(0.75))[kept])
    np.testing.assert_array_equal(o[3000:], f[3000:])
    again = drop(feats, valid, deterministic=False,
                 generator=torch.Generator().manual_seed(7))
    assert torch.equal(again, out)


def test_dropout_whole_rows():
    feats = torch.ones((2000, 4))
    out = tfac.SparseDropout(0.5, per_channel=False)(
        feats, torch.ones(2000, dtype=torch.bool), deterministic=False,
        generator=torch.Generator().manual_seed(3))
    rows = out.numpy()
    assert set(np.unique(rows)) == {0.0, 2.0}
    assert (rows == rows[:, :1]).all()
    assert abs((rows[:, 0] == 0).mean() - 0.5) < 0.05
