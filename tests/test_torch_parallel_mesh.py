"""Data parallelism over ranks (detection_3d_tpu_torch/parallel/mesh.py
and collectives.py) on the CPU: gloo ranks started by
``parallel.mesh.launch`` (spawned processes meeting through a
``file://`` rendezvous in the test's temporary directory) run the rank
functions of ``parallel/checks.py``.

  * the collectives' forward and backward against their single-process
    formulas, on 2 and 3 ranks;
  * one 2-rank data-parallel step at the tiny config against the JAX
    package: JAX's single-building ``value_and_grad`` of each of the two
    buildings with the key JAX's batched step gives it
    (``split(fold_in(rng, d), 1)[0]`` on dp rank d; its samplers' draws
    handed to the port), averaged. Losses within rtol 1e-5, gradients
    within atol 1e-5 + rtol 1e-3 (tests/test_torch_train_step.py's
    tolerances), the parameters after the update within atol 1e-6 of
    optax's update of the mean gradient and bit equal across ranks;
  * ``Trainer(mesh=...)`` for one epoch with a non-finite building (the
    step holding it skipped on every rank, parameters equal across
    ranks, checkpoints written once) and with eval-in-train (every
    building of the epoch evaluated);
  * the CLI under ``torchrun --standalone`` with 2 gloo ranks, where only
    rank 0 writes.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.engine.solver import make_optimizer
from detection_3d_tpu.models.detector import (
    SparseRCNN as JRCNN, voxelize_points as jvox)
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu_torch.engine.trainer import cycle_pad, pad_scene
from detection_3d_tpu_torch.models.detector import SparseRCNN
from detection_3d_tpu_torch.parallel.checks import (
    collectives_job, dp_step_job, rank_input, trainer_job)
from detection_3d_tpu_torch.parallel.mesh import (
    Mesh, dp_batch_size, launch, rank_generator)
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from test_torch_common import cfg_pair, tiny_scene, to_numpy_tree

ROOT = Path(__file__).resolve().parent.parent
LOSS_NAMES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier_roi",
              "loss_box_reg_roi")


def _init_file(factory, name):
    return str(factory.mktemp("dist") / name)


# ---- the collectives --------------------------------------------------------


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return {n: launch(collectives_job, n, "gloo",
                      _init_file(tmp_path_factory, f"coll{n}"), args=(5,))
            for n in (2, 3)}


def _want(name, n, r):
    xs = [rank_input(5, q) for q in range(n)]
    cts = [rank_input(6, q) for q in range(n)]
    zero = np.zeros_like(xs[0])
    if name == "all_reduce_sum":
        return sum(xs), sum(cts)
    if name == "all_gather_rows":       # cotangents tiled over the rows
        return np.concatenate(xs), sum(cts)
    off = 1 if name == "shift+1" else -1
    src, dst = r - off, r + off       # rank r gets src's, feeds dst's
    return (xs[src] if 0 <= src < n else zero,
            cts[dst] if 0 <= dst < n else zero)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", ["all_reduce_sum", "all_gather_rows",
                                  "shift+1", "shift-1"])
def test_collective_forward_and_backward(collectives, name, n):
    for r, out in enumerate(collectives[n]):
        want, want_grad = _want(name, n, r)
        np.testing.assert_allclose(out[name], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out[name + ".grad"], want_grad,
                                   rtol=1e-6, atol=1e-6)


def test_gather_takes_bf16_and_bool(collectives):
    xs = np.concatenate([rank_input(5, q) for q in range(3)])
    for out in collectives[3]:
        want = torch.from_numpy(xs).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(out["bf16"], want)
        np.testing.assert_array_equal(out["bool"], xs > 0)


def test_batch_size_and_generators():
    """JAX's rounding of the step's buildings; per-rank generators draw
    apart and one dp rank's draw the same."""
    assert [dp_batch_size(b, 4) for b in (1, 4, 6, 9)] == [4, 4, 8, 12]
    assert dp_batch_size(3, 1) == 3
    draws = [torch.rand(8, generator=rank_generator(0, d, "cpu"))
             for d in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


def test_launch_reports_a_failing_rank(tmp_path):
    """A rank that raises (here: asked for a card where there is none)
    fails the launch with its traceback, and every rank is stopped."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch(collectives_job, 2, "gloo", str(tmp_path / "init"),
               args=(5, "cuda"))


# ---- one data-parallel step against JAX -------------------------------------


@pytest.fixture(scope="module")
def jax_dp():
    """JAX parameters, each building's losses and gradients with the key
    JAX's batched step gives dp rank d (one building a rank), the mean
    gradient's optax update, and the samplers' draws."""
    jcfg, tcfg = cfg_pair()
    batches = [pad_scene(tcfg, tiny_scene(s)) for s in (0, 1)]
    rng = jax.random.PRNGKey(7)
    model = JRCNN(jcfg)
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    table0 = jvox(jcfg, jb0["points"], jb0["feats"], jb0["points_valid"])
    params = jax.jit(functools.partial(model.init, is_train=True))(
        rng, table0, JBoxes3D(jb0["gt_boxes"], jb0["gt_valid"]),
        jb0["gt_labels"], rng=rng)

    @jax.jit
    def grads_of(params, b, key):
        def loss_fn(p):
            table = jvox(jcfg, b["points"], b["feats"], b["points_valid"])
            losses, _ = model.apply(
                p, table, JBoxes3D(b["gt_boxes"], b["gt_valid"]),
                b["gt_labels"], is_train=True, rng=key)
            return sum(jax.tree_util.tree_leaves(losses)), (
                losses, table.true_num)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    shapes = SparseRCNN(tcfg).priority_shapes()
    per, pri = [], []
    for d, b in enumerate(batches):
        key = jax.random.split(jax.random.fold_in(rng, d), 1)[0]
        (total, (losses, tn)), g = grads_of(
            params, {k: jnp.asarray(v) for k, v in b.items()}, key)
        per.append((float(total), {k: float(v) for k, v in losses.items()},
                    int(tn), g))
        pri.append({"rpn": np.array(jax.random.uniform(
                        jax.random.fold_in(key, 0), (shapes["rpn"],))),
                    "roi": np.array(jax.random.uniform(
                        jax.random.fold_in(key, 1000), (shapes["roi"],)))})
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, per[0][3],
                                  per[1][3])
    tx, _ = make_optimizer(jcfg, params, 1)
    updates, _ = tx.update(mean, tx.init(params), params)
    new = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    return {"cfg": tcfg, "batches": batches, "priorities": pri,
            "params": to_numpy_tree(params),
            "total": np.mean([p[0] for p in per]),
            "losses": {k: np.mean([p[1][k] for p in per])
                       for k in LOSS_NAMES},
            "true_num": max(p[2] for p in per),
            "grads": convert_jax_params(to_numpy_tree(mean)),
            "new_params": convert_jax_params(to_numpy_tree(new))}


@pytest.fixture(scope="module")
def port_dp(jax_dp, tmp_path_factory):
    """The port's 2-rank step from the JAX parameters with JAX's draws."""
    cfg = jax_dp["cfg"]
    state = {k: v.numpy() for k, v in SparseRCNN(cfg).load_jax_params(
        jax_dp["params"]).state_dict().items()}
    return launch(dp_step_job, 2, "gloo",
                  _init_file(tmp_path_factory, "dp"),
                  args=(cfg, state, jax_dp["batches"],
                        jax_dp["priorities"]))


@pytest.mark.parametrize("name", ("total",) + LOSS_NAMES)
def test_dp_losses_match_jax_mean(jax_dp, port_dp, name):
    for out in port_dp:
        got = out["total"] if name == "total" else out["losses"][name]
        want = jax_dp["total"] if name == "total" else \
            jax_dp["losses"][name]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        assert bool(out["ok"])
        assert int(out["true_num"]) == jax_dp["true_num"]


@pytest.mark.parametrize("part", ["backbone", "rpn", "roi_head"])
def test_dp_gradients_match_jax_mean(jax_dp, port_dp, part):
    names = [n for n in jax_dp["grads"] if n.startswith(part + ".")]
    assert names
    for out in port_dp:
        for n in names:
            np.testing.assert_allclose(
                out["grads"][n], jax_dp["grads"][n].numpy(), rtol=1e-3,
                atol=1e-5, err_msg=n)


def test_dp_update_matches_optax_and_ranks_agree(jax_dp, port_dp):
    a, b = port_dp[0]["params"], port_dp[1]["params"]
    for n, want in jax_dp["new_params"].items():
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
        np.testing.assert_allclose(a[n], want.numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


# ---- Trainer(mesh=...) and the CLI ------------------------------------------


def _solver_cfg(cfg, **kw):
    return cfg.replace(solver=dataclasses.replace(cfg.solver, **kw))


def test_trainer_dp_gates_a_non_finite_step_on_every_rank(tmp_path):
    _, tcfg = cfg_pair()
    cfg = _solver_cfg(tcfg, ims_per_batch=2)
    bad = dict(tiny_scene(1))
    bad["feats"] = np.full_like(bad["feats"], np.nan)
    scenes = [tiny_scene(0), bad, tiny_scene(2)]
    out = tmp_path / "out"
    res = launch(trainer_job, 2, "gloo", str(tmp_path / "init"),
                 args=(cfg, scenes, str(out)))
    # JAX's order: the epoch's permutation cycle-padded to bsz = 2
    order = cycle_pad(list(np.random.default_rng(77).permutation(3)), 2)
    want_ok = [1 not in order[i:i + 2] for i in (0, 2)]
    for r in res:
        assert r["step"] == 2
        assert [ok for _, ok in r["history"]] == want_ok
        np.testing.assert_array_equal(   # the same totals, NaN included
            [t for t, _ in r["history"]], [t for t, _ in res[0]["history"]])
        for n, p in r["params"].items():
            np.testing.assert_array_equal(p, res[0]["params"][n])
    init = SparseRCNN(cfg, seed=0).state_dict()
    assert any(not np.array_equal(res[0]["params"][n], init[n].numpy())
               for n in res[0]["params"])
    assert {"model_final.pt", "last_checkpoint"} <= set(os.listdir(out))
    state = torch.load(out / "model_final.pt", weights_only=False)
    for n, p in res[0]["params"].items():
        np.testing.assert_array_equal(state["model"][n].numpy(), p)


def test_trainer_dp_eval_in_train_gathers_every_building(tmp_path):
    _, tcfg = cfg_pair()
    cfg = _solver_cfg(tcfg.replace(eval_in_train=1), ims_per_batch=2)
    scenes = [tiny_scene(s) for s in range(3)]
    res = launch(trainer_job, 2, "gloo", str(tmp_path / "init"),
                 args=(cfg, scenes, str(tmp_path / "out")))
    order = cycle_pad(list(np.random.default_rng(77).permutation(3)), 2)
    want = sum(np.bincount(scenes[i]["gt_labels"],
                           minlength=cfg.num_classes) for i in order)
    want[0] = 0
    for r in res:
        assert [ok for _, ok in r["history"]] == [True, True]
        np.testing.assert_array_equal(r["n_gt"], want)


def test_trainer_takes_only_a_dp_mesh(tmp_path):
    from detection_3d_tpu_torch.engine.trainer import Trainer
    _, tcfg = cfg_pair()
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="dp"):
        Trainer(tcfg, str(tmp_path), mesh=Mesh(("sp",), (2,), 0, 2, cpu,
                                               "gloo"))
    # a (dp, sp) mesh: its sp ranks would train the same buildings again
    with pytest.raises(ValueError, match="spatially sharded"):
        Trainer(tcfg, str(tmp_path), mesh=Mesh(("dp", "sp"), (2, 2), 0, 4,
                                               cpu, "gloo"))
    t = Trainer(_solver_cfg(tcfg, ims_per_batch=3), str(tmp_path),
                mesh=Mesh(("dp",), (2,), 1, 2, cpu, "gloo", {"dp": None},
                          {"dp": 1}))
    assert t.batch_size() == 4 and not t.is_main and t.logger is None


def test_cli_under_torchrun_trains_data_parallel(tmp_path):
    from test_torch_train_net import TINY_OPTS, TINY_YAML
    out = tmp_path / "out"
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML.format(out=out).replace(
        "SOLVER:\n", "SOLVER:\n  IMS_PER_BATCH: 2\n"))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "detection_3d_tpu_torch.tools.train_net", "--config-file",
         str(path), "--synthetic", "3", "--device", "cpu",
         "--dist-backend", "gloo", *TINY_OPTS], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert set(os.listdir(out)) == {
        "log.txt", "tiny.yaml", "last_checkpoint", "model_0000000.pt",
        "model_final.pt", "model_min_loss.pt"}
    log = (out / "log.txt").read_text()
    # only rank 0 logs: each line once
    assert log.count("data-parallel: 2 ranks, 2 buildings/step") == 1
    assert log.count("config: ") == 1
    assert log.count("iter 0 epoch 0") == 1
    assert log.count("Saved checkpoint to") == 3
    # 3 buildings, 2 a step: 2 steps
    assert torch.load(out / "model_final.pt", weights_only=False)[
        "step"] == 2
    assert log.count("class      AP      AIoU") == 1
    assert "rank 0's 1 buildings" in log          # 1 test building, 2 ranks
