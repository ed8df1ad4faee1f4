"""The port's twin of tools/train_bench.py
(detection_3d_tpu_torch/tools/train_bench.py) on the CPU: at the tiny
config, its steps' losses equal Trainer.step's on the same weights and
sampler draws (the same seed), the step counts and voxel count agree,
and every device field reads None (not measured) on the CPU. Its two
configurations are the JAX tool's (generalization_check.gen_config with
a 35k-point varied building; full_scale_config with bench.py's
building)."""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401 (one torch thread per worker)
from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
from detection_3d_tpu_torch.tools import train_bench
from test_torch_common import cfg_pair, tiny_scene


@pytest.fixture(scope="module")
def bench_and_trainer(tmp_path_factory):
    _, tcfg = cfg_pair()
    scene = tiny_scene(0)
    r = train_bench.run(tcfg, scene, "cpu", iters=1, seed=0)
    trainer = Trainer(tcfg, output_dir=str(tmp_path_factory.mktemp("tb")),
                      device="cpu")
    state = trainer.init_state(seed=0, iters_per_epoch=1)
    gen = torch.Generator(device="cpu").manual_seed(0)
    batch = pad_scene(tcfg, scene)
    steps = [trainer.step(state, batch, gen) for _ in range(2)]
    return r, steps


def test_losses_equal_trainer_steps(bench_and_trainer):
    r, steps = bench_and_trainer
    assert r["losses"] == [s[0] for s in steps]
    assert r["first_loss"] == steps[0][0] and r["first_ok"] == steps[0][2]
    assert r["voxels"] == steps[0][3] > 0
    assert all(np.isfinite(r["losses"]))


def test_device_fields_are_not_measured_on_the_cpu(bench_and_trainer):
    r, _ = bench_and_trainer
    assert r["first_step_s"] > 0 and r["s_per_step"] > 0 and r["iters"] == 1
    for key in ("device_s_per_step", "idle_share", "top_ms_per_step"):
        assert r[key] is None, key


def test_configs_are_the_jax_tools(monkeypatch):
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.tools.generalization_check import gen_config
    from detection_3d_tpu_torch.data import synthetic
    made = {}
    monkeypatch.setattr(synthetic, "synthetic_varied_building",
                        lambda **kw: made.setdefault("gen", kw))
    monkeypatch.setattr(synthetic, "synthetic_multiroom",
                        lambda **kw: made.setdefault("full", kw))
    cfg, _ = train_bench.bench_setup("gen")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(gen_config())
    assert made["gen"] == {"seed": 0, "num_points": 35_000,
                           "classes": cfg.classes, "voxel_scale": 25}
    cfg, _ = train_bench.bench_setup("full")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(full_scale_config())
    assert made["full"] == {"seed": 0, "num_points": 500_000,
                            "rooms_xy": (5, 5), "room": 8.0,
                            "voxel_scale": 50}
    with pytest.raises(ValueError, match="config"):
        train_bench.bench_setup("tiny")
