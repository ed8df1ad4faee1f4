"""The RPN-only model (``cfg.rpn_only``: no ROI head, the proposals are
the detections) at the tiny config, JAX package against the port on the
CPU, with one group and with the 3G6c groups.

Per group count, one JAX ``init`` (its parameter tree has no
``roi_head``, and the port loads it strictly), one jitted predict and
one jitted ``value_and_grad`` of the training forward (module
fixtures). The port takes JAX's sampler draws (``fold_in(rng, gi)``).
Detections: the valid rows equal as sets (boxes and scores within 1e-4),
in descending score within each group in both packages, every label 1
(with groups: 1 mapped to the group's first class id by the merge),
equal ``true_num``; losses within rtol 1e-5, gradients within atol
1e-5 + rtol 1e-3. A unit of two buildings (make_batch_predict_fn) gives
each the bits of its own predict, with one group and with groups.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.engine.inference import make_predict_fn as j_predict_fn
from detection_3d_tpu.models.detector import (
    SparseRCNN as JRCNN, voxelize_points as jvox)
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu_torch.data.packing import batch_to_device, pack_table
from detection_3d_tpu_torch.engine.inference import (
    make_batch_predict_fn, make_predict_fn, pad_scene)
from detection_3d_tpu_torch.engine.trainer import Trainer, total_loss
from detection_3d_tpu_torch.models.detector import (
    SparseRCNN, rpn_detections, voxelize_points)
from detection_3d_tpu_torch.models.separate_classifier import (
    grouped_class_ids)
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from test_torch_common import cfg_pair, tiny_scene, to_numpy_tree
from test_torch_separate_classifier import (
    jax_priorities, sep_pair, sep_scene)

FORMS = {"one_group": (lambda: cfg_pair(rpn_only=True), tiny_scene),
         "groups": (lambda: sep_pair(rpn_only=True), sep_scene)}


def _scored_rows(out):
    """Valid rows of a packed (K, 10) output, in the output's order."""
    a = np.asarray(out)
    return a[a[:, 9] > 0.5]


@pytest.fixture(scope="module", params=sorted(FORMS))
def jax_run(request):
    make_pair, make_scene = FORMS[request.param]
    jcfg, tcfg = make_pair()
    batch = pad_scene(tcfg, make_scene())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    table = jvox(jcfg, jb["points"], jb["feats"], jb["points_valid"])
    gt = JBoxes3D(jb["gt_boxes"], jb["gt_valid"])
    rng = jax.random.PRNGKey(0)
    model = JRCNN(jcfg)
    params = jax.jit(lambda k: model.init(k, table, is_train=False))(rng)
    out, true_num = j_predict_fn(jcfg)(params, jb)

    @jax.jit
    def value_and_grad(params):
        def loss_fn(p):
            losses, _ = model.apply(p, table, gt, jb["gt_labels"],
                                    is_train=True, rng=rng)
            return sum(jax.tree_util.tree_leaves(losses)), losses
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, losses), grads = value_and_grad(params)
    return {"name": request.param, "cfg": tcfg, "batch": batch,
            "params": to_numpy_tree(params), "out": np.asarray(out),
            "true_num": int(true_num),
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": convert_jax_params(to_numpy_tree(grads)),
            "priorities": jax_priorities(
                rng, SparseRCNN(tcfg).priority_shapes())}


def test_parameter_tree_has_no_roi_head_and_loads_strictly(jax_run):
    assert "roi_head" not in jax_run["params"]["params"]
    model = SparseRCNN(jax_run["cfg"]).load_jax_params(jax_run["params"])
    assert not hasattr(model, "roi_head")
    assert len(model.state_dict()) == \
        len(jax.tree_util.tree_leaves(jax_run["params"]))
    extra = dict(jax_run["params"]["params"],
                 roi_head={"w": np.zeros((1,), np.float32)})
    with pytest.raises(RuntimeError):
        SparseRCNN(jax_run["cfg"]).load_jax_params({"params": extra})


def test_proposals_match_jax(jax_run):
    cfg = jax_run["cfg"]
    model = SparseRCNN(cfg).load_jax_params(jax_run["params"])
    out, true_num = make_predict_fn(cfg, model, device="cpu")(
        jax_run["batch"])
    assert int(true_num) == jax_run["true_num"]
    assert out.shape == jax_run["out"].shape == \
        (model.groups * cfg.rpn_post_nms_top_n_test, 10)
    want, got = _scored_rows(jax_run["out"]), _scored_rows(out.numpy())
    assert want.shape[0] > 0 and got.shape == want.shape
    # descending objectness within each group's block, in both; label 1,
    # which the merge of G groups maps to the group's first class id
    per = cfg.rpn_post_nms_top_n_test
    groups = grouped_class_ids(cfg) if model.groups > 1 else ((0, 1),)
    for a in (jax_run["out"], out.numpy()):
        for gi in range(model.groups):
            blk = a[gi * per:(gi + 1) * per]
            assert np.all(blk[blk[:, 9] > 0.5, 8] == groups[gi][1])
            s = blk[blk[:, 9] > 0.5, 7]
            assert np.all(np.diff(s) <= 0)
            # invalid rows after the valid ones
            v = blk[:, 9] > 0.5
            assert not np.any(v[np.argmin(v):]) or v.all()
    order_w = np.lexsort(want[:, :8].T[::-1])
    order_g = np.lexsort(got[:, :8].T[::-1])
    np.testing.assert_allclose(got[order_g, :8], want[order_w, :8],
                               atol=1e-4, rtol=0)


def test_losses_and_gradients_match_jax(jax_run):
    cfg = jax_run["cfg"]
    model = SparseRCNN(cfg).load_jax_params(jax_run["params"])
    (pts, fts, valid), gt, gt_labels = batch_to_device(jax_run["batch"],
                                                       "cpu")
    losses = model(voxelize_points(cfg, pts, fts, valid), gt, gt_labels,
                   priorities=jax_run["priorities"])
    assert isinstance(losses, dict)
    assert set(losses) == set(jax_run["losses"])
    assert len(losses) == 2 * model.groups
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), jax_run["losses"][k],
                                   rtol=1e-5, atol=0, err_msg=k)
    total_loss(losses).backward()
    for name, p in model.named_parameters():
        want = jax_run["grads"][name].numpy()
        assert (p.grad is None) == (not want.any()), name
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_priority_shapes_hold_no_roi_draw(jax_run):
    shapes = SparseRCNN(jax_run["cfg"]).priority_shapes()
    assert not any(k.startswith("roi") for k in shapes)
    assert len(shapes) == (1 if jax_run["name"] == "one_group" else 3)


def test_trainer_steps_an_rpn_only_model(jax_run, tmp_path):
    cfg = jax_run["cfg"]
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    model = SparseRCNN(cfg).load_jax_params(jax_run["params"])
    state = trainer.init_state(model=model)
    total, losses, ok, _ = trainer.step(state, jax_run["batch"],
                                        priorities=jax_run["priorities"])
    assert ok and state.solver.count == 1
    np.testing.assert_allclose(total, sum(jax_run["losses"].values()),
                               rtol=1e-5)


def test_rpn_detections_order_ties_and_invalid_rows():
    """A stable descending sort: equal scores keep their index order,
    invalid rows (any score) go last in index order, as JAX's
    ``argsort(-score)`` with -inf there."""
    obj = torch.tensor([0.5, 0.9, 0.5, 0.7, 0.9, 0.1])
    valid = torch.tensor([True, True, True, False, True, False])
    p = Boxes3D(torch.arange(6, dtype=torch.float32)[:, None].repeat(1, 7),
                valid, {"objectness": obj, "is_gt": torch.zeros(6)})
    d = rpn_detections(p)
    want = np.asarray(jnp.argsort(-jnp.where(jnp.asarray(valid.numpy()),
                                             jnp.asarray(obj.numpy()),
                                             -jnp.inf)))
    np.testing.assert_array_equal(want, [1, 4, 0, 2, 3, 5])
    np.testing.assert_array_equal(d.boxes[:, 0].numpy(), want)
    np.testing.assert_array_equal(d.valid.numpy(),
                                  [True, True, True, True, False, False])
    assert d.fields["labels"].dtype == torch.int32
    assert torch.all(d.fields["labels"] == 1)
    np.testing.assert_array_equal(d.fields["scores"].numpy(),
                                  obj.numpy()[[1, 4, 0, 2, 3, 5]])


@pytest.mark.parametrize("form", sorted(FORMS))
def test_batch_predict_matches_per_building(form):
    """One forward over a unit of two buildings (table form) gives each
    building the bits of its own predict."""
    make_pair, make_scene = FORMS[form]
    _, tcfg = make_pair()
    model = SparseRCNN(tcfg, seed=0)
    packs = [pack_table(tcfg, make_scene(seed)) for seed in (0, 1)]
    out, true_num = make_batch_predict_fn(tcfg, model, device="cpu",
                                          packed="table")(
        {k: np.stack([p[k] for p in packs]) for k in packs[0]})
    one = make_predict_fn(tcfg, model, device="cpu", packed="table")
    for b, p in enumerate(packs):
        o, t = one(p)
        assert torch.equal(out[b], o) and int(true_num[b]) == int(t)
