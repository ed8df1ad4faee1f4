"""The training input path's host pyramid and the packed training step,
on the CPU.

A pack made with ``backward=True`` (data/pyramid_packing.pack_pyramid,
and the C++ packer byte for byte) carries the backward books' entry
lists and the BEV transposes; ``unpack_pyramid(..., backward=True)``
must give every BackwardBook field of ``build_pyramid(...,
backward=True)`` on unpack_table's table of the same pack, bit for bit,
for every book kind, with and without the capacity-overflow keep at
scale 0. The packed step (``Trainer.step(..., packed="pyramid")``)
must equal the step on unpack_table's table bit for bit, run no
build_pyramid and no kernel B, and match the JAX package's packed
``value_and_grad`` (over ``model.apply(..., pyramid=unpack_pyramid(...))``
with JAX's sampler draws) within the tolerances of
tests/test_torch_train_step.py: losses rtol 1e-5, gradients atol 1e-5 +
rtol 1e-3.
"""

import copy
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.data import pyramid_packing as jpyr
from detection_3d_tpu.models.detector import SparseRCNN as JRCNN
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu_torch.data import native_packer
from detection_3d_tpu_torch.data import pyramid_packing as tpyr
from detection_3d_tpu_torch.data.packing import to_device, unpack_table
from detection_3d_tpu_torch.engine.trainer import (
    Trainer, grads_finite, total_loss)
from detection_3d_tpu_torch.models import backbone as tbackbone
from detection_3d_tpu_torch.models import detector as tdetector
from detection_3d_tpu_torch.models.backbone import build_pyramid
from detection_3d_tpu_torch.models.detector import SparseRCNN
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from test_torch_common import cfg_pair, tiny_scene, to_numpy_tree

CAPS0 = {"fits": 8192, "overflow": 4096, "overflow6": 1024}
KINDS = ("subm_bwd", "down_bwd", "up_bwd", "bev_bwd")


def _cfg(case):
    _, tc = cfg_pair()
    return dataclasses.replace(tc, caps=dataclasses.replace(
        tc.caps, voxel_caps=(CAPS0[case],) + tc.caps.voxel_caps[1:]))


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("case", sorted(CAPS0))
def test_native_backward_fields_equal_numpy(case, n_threads):
    cfg = _cfg(case)
    scene = tiny_scene(11)
    want = tpyr.pack_pyramid(cfg, scene, backward=True)
    got = native_packer.pack_pyramid_native(cfg, scene, n_threads=n_threads,
                                            backward=True)
    assert set(got) == set(want)
    extra = set(want) - set(tpyr.pack_pyramid(cfg, scene))
    assert extra and all(k.endswith(("_entries", "_starts")) or "_t_" in k
                         for k in extra)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_backward_spec_matches_pack():
    cfg = _cfg("fits")
    got = tpyr.pack_pyramid(cfg, tiny_scene(8), backward=True)
    spec = tpyr.pyramid_pack_spec(cfg, backward=True)
    assert set(spec) - set(tpyr.pyramid_pack_spec(cfg)) == \
        set(got) - set(tpyr.pack_pyramid(cfg, tiny_scene(8)))
    for k, (shape, dt) in spec.items():
        a = np.asarray(got[k])
        assert a.dtype == dt, k
        if k.endswith("_entries"):    # the most entries the book holds
            assert a.shape[1] == 2 and 0 < a.shape[0] <= shape[0], k
            assert a.shape[0] == got[k[:-len("entries")] + "starts"][-1], k
        else:
            assert a.shape == shape, k


@pytest.mark.parametrize("book", ["subm0", "down0", "bev0"])
def test_native_entries_overflow_raises(book, monkeypatch):
    # an _entries buffer smaller than its book's entries fails the run
    # (the spec's worst case disagreeing with the packer), not a write
    # past its end
    spec = native_packer.pyramid_pack_spec

    def small(cfg, backward=False):
        out = dict(spec(cfg, backward))
        out[f"{book}_entries"] = ((3, 2), np.int32)
        return out

    monkeypatch.setattr(native_packer, "pyramid_pack_spec", small)
    with pytest.raises(RuntimeError,
                       match=f"{book}_entries: more entries than its "
                             "buffer of 3 holds"):
        native_packer.pack_pyramid_native(_cfg("fits"), tiny_scene(11),
                                          backward=True)


def _assert_books_equal(a, b, name):
    for f in ("t_idx", "entries", "starts"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (name, f)
        assert torch.equal(x, y), (name, f)
    for f in ("perm", "masks"):
        x, y = getattr(a.t_order, f), getattr(b.t_order, f)
        assert x.dtype == y.dtype and torch.equal(x, y), (name, f)
    assert a.reversed == b.reversed, name


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CAPS0))
def test_unpacked_books_equal_build_pyramid(case, kind):
    cfg = _cfg(case)
    packed = to_device(native_packer.pack_pyramid_native(
        cfg, tiny_scene(9), backward=True), "cpu")
    got = tpyr.unpack_pyramid(cfg, packed, backward=True)
    want = build_pyramid(unpack_table(cfg, packed), cfg, backward=True)
    assert set(got) == set(want)
    if kind == "bev_bwd":
        assert set(got["bev"]) == set(want["bev"])
        pairs = [(got["bev"][s][1].bwd, want["bev"][s][1].bwd)
                 for s in want["bev"]]
    else:       # the backward books of the kind's Books
        key = kind[:-len("_bwd")]
        assert len(got[key]) == len(want[key]) > 0
        pairs = [(a.bwd, b.bwd) for a, b in zip(got[key], want[key])]
    for i, (a, b) in enumerate(pairs):
        _assert_books_equal(a, b, f"{kind}[{i}]")


def test_np_transpose_raises_on_a_repeated_input_row():
    idx = np.array([[0, 1, 0], [2, 1, 0]], np.int32)
    with pytest.raises(ValueError, match="same input row"):
        tpyr.np_transpose(idx, 3, 3)          # offset 0 reads row 0 twice
    t = tpyr.np_transpose(idx, 2, 3)          # output row 2 is not valid
    np.testing.assert_array_equal(t, [[0, 1, 3], [3, 1, 0]])
    entries, starts = tpyr.np_entries(idx, 2, 3)
    assert entries.tolist() == [[0, 0], [1, 1], [2, 0], [1, 1]]
    assert starts.tolist() == [0, 2, 4]


# ---- the packed step -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_packed():
    """JAX params, and the losses and gradients of its packed training
    forward (trainer.py:_build_packed_step's loss_fn), with the samplers'
    draws."""
    jcfg, tcfg = cfg_pair()
    scene = tiny_scene(5)
    jb = {k: jnp.asarray(v) for k, v in jpyr.pack_pyramid(jcfg,
                                                           scene).items()}
    table, pyramid = jpyr.unpack_pyramid(jcfg, jb)
    gt = JBoxes3D(jb["gt_boxes"], jb["gt_valid"])
    rng = jax.random.PRNGKey(0)
    model = JRCNN(jcfg)
    params = jax.jit(functools.partial(model.init, is_train=True))(
        rng, table, gt, jb["gt_labels"], rng=rng)

    @jax.jit
    def value_and_grad(params):
        def loss_fn(p):
            losses, _ = model.apply(p, table, gt, jb["gt_labels"],
                                    is_train=True, rng=rng, pyramid=pyramid)
            return sum(jax.tree_util.tree_leaves(losses)), losses
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (total, losses), grads = value_and_grad(params)
    shapes = SparseRCNN(tcfg).priority_shapes()
    pri = {"rpn": jax.random.uniform(jax.random.fold_in(rng, 0),
                                     (shapes["rpn"],)),
           "roi": jax.random.uniform(jax.random.fold_in(rng, 1000),
                                     (shapes["roi"],))}
    return {"cfg": tcfg, "scene": scene, "params": to_numpy_tree(params),
            "total": float(total),
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": convert_jax_params(to_numpy_tree(grads)),
            "priorities": {k: torch.from_numpy(np.array(v))
                           for k, v in pri.items()}}


def test_packed_forward_matches_jax(jax_packed):
    cfg = jax_packed["cfg"]
    model = SparseRCNN(cfg).load_jax_params(jax_packed["params"])
    b = to_device(tpyr.pack_pyramid(cfg, jax_packed["scene"], backward=True),
                  "cpu")
    pyr = tpyr.unpack_pyramid(cfg, b, backward=True)
    losses = model(pyr["tables"][0], Boxes3D(b["gt_boxes"], b["gt_valid"]),
                   b["gt_labels"], priorities=jax_packed["priorities"],
                   pyramid=pyr)
    total = total_loss(losses)
    total.backward()
    assert set(losses) == set(jax_packed["losses"])
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()),
                                   jax_packed["losses"][k], rtol=1e-5,
                                   atol=0, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), jax_packed["total"],
                               rtol=1e-5)
    for name, p in model.named_parameters():
        want = jax_packed["grads"][name].numpy()
        # an unused decoder level: no gradient in the port, zeros in JAX
        assert (p.grad is None) == (not want.any()), name
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def _table_form_step(trainer, state, packed, priorities):
    """The step on unpack_table's table of the same pack, the card's
    pyramid built in the forward (what the packed step stands for)."""
    b = to_device(packed, "cpu")
    state.solver.zero_grad()
    losses = state.model(unpack_table(trainer.cfg, b),
                         Boxes3D(b["gt_boxes"], b["gt_valid"]),
                         b["gt_labels"], priorities=priorities)
    total = total_loss(losses)
    total.backward()
    ok = grads_finite(total, state.solver.params)
    state.solver.apply(ok)
    return (float(total.detach()),
            {k: float(v.detach()) for k, v in losses.items()}, bool(ok))


def test_packed_step_equals_the_table_step(jax_packed, tmp_path,
                                           monkeypatch):
    cfg = jax_packed["cfg"]
    pri = jax_packed["priorities"]
    packed = tpyr.pack_pyramid(cfg, jax_packed["scene"], backward=True)
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    base = SparseRCNN(cfg).load_jax_params(jax_packed["params"])
    s_table = trainer.init_state(model=copy.deepcopy(base))
    s_packed = trainer.init_state(model=copy.deepcopy(base))
    total_t, losses_t, ok_t = _table_form_step(trainer, s_table, packed, pri)

    def refuse(*a, **kw):
        raise AssertionError("the packed step built a pyramid")
    monkeypatch.setattr(tdetector, "build_pyramid", refuse)
    monkeypatch.setattr(tbackbone, "neighbor_match_3x3x3", refuse)
    for form in (packed, to_device(packed, "cpu")):     # numpy, tensors
        state = trainer.init_state(model=copy.deepcopy(base))
        total, losses, ok, true_num = trainer.step(state, form,
                                                   priorities=pri,
                                                   packed="pyramid")
        assert (total, losses, ok) == (total_t, losses_t, ok_t) and ok
        assert true_num == int(packed["true_num"]) and state.step == 1
        assert state.solver.count == 1
        for (n, p), q in zip(state.model.named_parameters(),
                             s_table.model.parameters()):
            assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="packed"):
        trainer.step(s_packed, packed, packed="table")
