"""One training step at the tiny config, JAX package against the port.

The JAX reference runs once per file (a module fixture): ``init`` with
``is_train=True`` and one jitted ``value_and_grad`` of the summed loss,
plus one optax update. The port takes the converted parameters and the
JAX samplers' own uniform draws (``fold_in(rng, 0)`` over the anchors
for the RPN, ``fold_in(rng, 1000)`` over the proposals for the ROI
head), and runs its plain kernels on the CPU.

Tolerances: each loss within rtol 1e-5 (f32 sums in another order);
each gradient within atol 1e-5 + rtol 1e-3 (the backward sums in
another order through ~40 convs and BN); the parameters after one SGD
step from the same gradients within atol 1e-7 (one f32 update).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.engine.solver import make_optimizer
from detection_3d_tpu.models.detector import (
    SparseRCNN as JRCNN, voxelize_points as jvox)
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu_torch.engine.trainer import (
    Trainer, batch_to_device, pad_scene, total_loss)
from detection_3d_tpu_torch.models.detector import (
    SparseRCNN, voxelize_points)
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from test_torch_common import cfg_pair, tiny_scene, to_numpy_tree

LOSS_NAMES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier_roi",
              "loss_box_reg_roi")


@pytest.fixture(scope="module")
def jax_step():
    """JAX params, losses, gradients, the optax update of one step, and
    the samplers' draws."""
    jcfg, tcfg = cfg_pair()
    batch = pad_scene(tcfg, tiny_scene())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    table = jvox(jcfg, jb["points"], jb["feats"], jb["points_valid"])
    gt = JBoxes3D(jb["gt_boxes"], jb["gt_valid"])
    rng = jax.random.PRNGKey(0)
    model = JRCNN(jcfg)
    params = jax.jit(functools.partial(model.init, is_train=True))(
        rng, table, gt, jb["gt_labels"], rng=rng)

    @jax.jit
    def step(params):
        def loss_fn(p):
            losses, _ = model.apply(p, table, gt, jb["gt_labels"],
                                    is_train=True, rng=rng)
            return sum(jax.tree_util.tree_leaves(losses)), losses
        (total, losses), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        tx, _ = make_optimizer(jcfg, params, 1)
        opt = tx.init(params)
        updates, opt = tx.update(grads, opt, params)
        return total, losses, grads, jax.tree_util.tree_map(
            lambda p, u: p + u, params, updates)

    total, losses, grads, new_params = step(params)
    shapes = SparseRCNN(tcfg).priority_shapes()
    pri = {"rpn": jax.random.uniform(jax.random.fold_in(rng, 0),
                                     (shapes["rpn"],)),
           "roi": jax.random.uniform(jax.random.fold_in(rng, 1000),
                                     (shapes["roi"],))}
    return {"cfg": tcfg, "batch": batch, "params": to_numpy_tree(params),
            "total": float(total),
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": convert_jax_params(to_numpy_tree(grads)),
            "new_params": convert_jax_params(to_numpy_tree(new_params)),
            "priorities": {k: torch.from_numpy(np.array(v))
                           for k, v in pri.items()}}


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's losses and gradients with the same weights and draws."""
    cfg = jax_step["cfg"]
    model = SparseRCNN(cfg).load_jax_params(jax_step["params"])
    (pts, fts, valid), gt, gt_labels = batch_to_device(jax_step["batch"],
                                                       "cpu")
    losses = model(voxelize_points(cfg, pts, fts, valid), gt, gt_labels,
                   priorities=jax_step["priorities"])
    total = total_loss(losses)
    total.backward()
    return model, {k: float(v.detach()) for k, v in losses.items()}, \
        float(total.detach())


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_matches_jax(jax_step, port_step, name):
    _, losses, _ = port_step
    assert set(losses) == set(LOSS_NAMES) == set(jax_step["losses"])
    np.testing.assert_allclose(losses[name], jax_step["losses"][name],
                               rtol=1e-5, atol=0)


def test_total_loss_matches_jax(jax_step, port_step):
    np.testing.assert_allclose(port_step[2], jax_step["total"], rtol=1e-5)


@pytest.mark.parametrize("part", ["backbone", "rpn", "roi_head"])
def test_gradients_match_jax(jax_step, port_step, part):
    model = port_step[0]
    checked = 0
    for name, p in model.named_parameters():
        if not name.startswith(part + "."):
            continue
        want = jax_step["grads"][name].numpy()
        got = (np.zeros_like(want) if p.grad is None
               else p.grad.numpy())
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        checked += 1
    assert checked > 0


def test_unused_parameters_get_no_gradient_in_either(jax_step, port_step):
    """The decoder levels below the deepest map a head reads: the port
    leaves their grad None, JAX gives zeros; both then move them by weight
    decay alone."""
    model = port_step[0]
    unused = [n for n, p in model.named_parameters() if p.grad is None]
    assert unused, "the tiny config has unused decoder levels"
    for n in unused:
        assert not np.any(jax_step["grads"][n].numpy()), n


def test_sgd_step_matches_optax(jax_step, tmp_path):
    """The JAX gradients through the port's solver give optax's new
    parameters, unused (zero-gradient) parameters included."""
    cfg = jax_step["cfg"]
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    model = SparseRCNN(cfg).load_jax_params(jax_step["params"])
    state = trainer.init_state(model=model)
    for name, p in model.named_parameters():
        g = jax_step["grads"][name]
        p.grad = None if not g.any() else g.clone()
    state.solver.apply()
    assert state.solver.count == 1
    moved_by_decay_only = 0
    for name, p in model.named_parameters():
        want = jax_step["new_params"][name]
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-7,
                                   msg=name)
        if not jax_step["grads"][name].any():
            old = torch.from_numpy(np.asarray(_leaf(jax_step["params"],
                                                    name)))
            moved_by_decay_only += int(not torch.equal(want, old))
    assert moved_by_decay_only > 0


def _leaf(tree, dotted):
    node = tree["params"]
    for part in dotted.split("."):
        node = node[part]
    return node


def test_non_finite_step_changes_nothing(jax_step, tmp_path):
    """After one applied step, a step whose input is NaN leaves the
    parameters, the momentum and the schedule's clock as they were;
    only the step count advances."""
    cfg = jax_step["cfg"]
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    model = SparseRCNN(cfg).load_jax_params(jax_step["params"])
    state = trainer.init_state(model=model)
    _, _, ok, _ = trainer.step(state, jax_step["batch"],
                               priorities=jax_step["priorities"])
    assert ok and state.solver.count == 1 and state.step == 1
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    momentum = {n: state.solver.optimizer.state[p]["momentum_buffer"]
                .clone() for n, p in model.named_parameters()}
    bad = dict(jax_step["batch"])
    bad["feats"] = np.full_like(bad["feats"], np.nan)
    total, _, ok, _ = trainer.step(state, bad,
                                   priorities=jax_step["priorities"])
    assert not ok and not np.isfinite(total)
    assert state.solver.count == 1 and state.step == 2
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
        assert torch.equal(state.solver.optimizer.state[p][
            "momentum_buffer"], momentum[n]), n
