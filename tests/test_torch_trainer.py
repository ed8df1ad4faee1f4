"""The port's training engine on the CPU: the torch Checkpointer (the
counterparts of tests/test_utils.py's checkpoint tests), its metric
logger, ``cycle_pad``, bad-scene culling, two epochs over two tiny
buildings, and the parts the Trainer does not port yet.
"""

import json
import os

import numpy as np
import pytest
import torch

from detection_3d_tpu_torch.engine.solver import is_bias
from detection_3d_tpu_torch.engine.trainer import (
    Trainer, check_capacities, cycle_pad)
from detection_3d_tpu_torch.utils.checkpoint import Checkpointer
from detection_3d_tpu_torch.utils.metric_logger import (
    MetricLogger, SmoothedValue)
from test_torch_common import cfg_pair, tiny_scene


def _state(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn((4, 3), generator=gen),
                      "b": torch.randn((3,), generator=gen)},
            "step": seed * 10}


def _assert_state_equal(a, b):
    assert torch.equal(a["model"]["w"], b["model"]["w"])
    assert torch.equal(a["model"]["b"], b["model"]["b"])
    assert int(a["step"]) == int(b["step"])


class TestCheckpointer:
    def test_save_load_roundtrip(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        state = _state(1)
        ck.save("model_0000010", state)
        _assert_state_equal(ck.load(_state(2)), state)

    def test_fresh_start_returns_template(self, tmp_path):
        template = _state(3)
        _assert_state_equal(Checkpointer(str(tmp_path)).load(template),
                            template)

    def test_last_checkpoint_tag_resumes_latest(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save("model_0000010", _state(1))
        ck.save("model_0000020", _state(2))
        assert ck.has_checkpoint()
        assert ck.get_checkpoint_file() == "model_0000020.pt"
        _assert_state_equal(ck.load(_state(9)), _state(2))

    def test_resume_overrides_explicit_path(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        explicit = ck.save("explicit", _state(1))
        ck.save("resumed", _state(2))
        _assert_state_equal(ck.load(_state(9), path=explicit), _state(2))

    def test_explicit_path_used_without_tag(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        path = ck.save("weights", _state(4))
        os.remove(ck._tag_file())
        _assert_state_equal(ck.load(_state(5), path=path), _state(4))

    def test_prune_keeps_tagged_final_minloss(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save("model_0000010", _state(1))
        ck.save("model_0000020", _state(2))
        ck.save("model_min_loss", _state(3))
        ck.save("model_final", _state(4))
        ck.save("model_0000030", _state(5))  # tagged last
        removed = ck.prune()
        assert sorted(os.path.basename(p) for p in removed) == \
            ["model_0000010.pt", "model_0000020.pt"]
        left = sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt"))
        assert left == ["model_0000030.pt", "model_final.pt",
                        "model_min_loss.pt"]
        _assert_state_equal(ck.load(_state(9)), _state(5))

    def test_prune_keep_last(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        for i in range(1, 5):
            ck.save(f"model_{i:07d}", _state(i))
        ck.save("model_final", _state(9))
        removed = ck.prune(keep_last=2)
        assert sorted(os.path.basename(p) for p in removed) == \
            ["model_0000001.pt", "model_0000002.pt"]

    def test_tag_survives_directory_move(self, tmp_path):
        src, dst = tmp_path / "out_a", tmp_path / "out_b"
        Checkpointer(str(src)).save("model_final", _state(6))
        os.rename(src, dst)
        _assert_state_equal(Checkpointer(str(dst)).load(_state(7)),
                            _state(6))


def test_metric_logger_window_and_text():
    sv = SmoothedValue(window_size=4)
    for v in range(10):
        sv.update(v)
    assert sv.avg == pytest.approx(7.5) and sv.median == 7
    assert sv.global_avg == pytest.approx(4.5)
    ml = MetricLogger(delimiter="; ")
    ml.update(loss=1.0)
    ml.update(loss=3.0)
    assert ml.loss.count == 2 and "2.0000" in str(ml)
    with pytest.raises(AttributeError):
        ml.not_a_meter


@pytest.mark.parametrize("order,k,want", [
    ([0, 1, 2, 3], 10, [0, 1, 2, 3, 0, 1, 2, 3, 0, 1]),
    ([0, 1, 2], 2, [0, 1, 2, 0]), ([5], 4, [5, 5, 5, 5]),
    ([0, 1], 2, [0, 1])])
def test_cycle_pad(order, k, want):
    assert cycle_pad(order, k) == want


def test_check_capacities_matches_jax():
    """Per-scale (true_num, capacity) of one building, as the JAX
    trainer's check_capacities reports them; an overflowing scale warns."""
    from detection_3d_tpu.engine.trainer import (
        check_capacities as j_check_capacities)
    jcfg, tcfg = cfg_pair()
    scene = tiny_scene(0)
    got = check_capacities(tcfg, scene, device="cpu")
    assert got == j_check_capacities(jcfg, scene)
    small = tcfg.replace(caps=tcfg.caps.__class__(
        max_points=8192, voxel_caps=(1024, 512, 256, 128, 64), max_gt=16))
    warned = []

    class Log:
        def warning(self, msg, *args):
            warned.append(msg % args)
    out = check_capacities(small, scene, logger=Log(), device="cpu")
    assert out[0][0] > out[0][1] and warned and "scale 0" in warned[0]


def test_bad_scene_is_culled_and_persisted(tmp_path):
    """A scene whose steps are non-finite ``bad_scene_strikes`` times
    leaves the rotation and is written to bad_scenes.json; the steps are
    faked, so only the bookkeeping runs."""
    _, tcfg = cfg_pair()
    trainer = Trainer(tcfg, output_dir=str(tmp_path), device="cpu")
    state = trainer.init_state()
    good, bad = tiny_scene(0), dict(tiny_scene(1), scene_name="house_b")
    bad["points"] = bad["points"] + 1000.0
    seen = []

    def fake_step(st, batch, generator=None, priorities=None):
        is_bad = bool(batch["points"][0, 0] > 500.0)
        seen.append(is_bad)
        st.step += 1
        return (float("nan") if is_bad else 1.0, {}, not is_bad, 100)

    trainer.step = fake_step
    trainer.train([good, bad], state, epochs=5)
    assert seen.count(True) == trainer.bad_scene_strikes == 3
    assert seen.count(False) == 5
    with open(tmp_path / "bad_scenes.json") as f:
        assert json.load(f) == ["house_b"]
    # every scene culled: the trainer stops with an error
    trainer2 = Trainer(tcfg, output_dir=str(tmp_path / "b"), device="cpu")
    trainer2.step = fake_step
    with pytest.raises(RuntimeError, match="culled"):
        trainer2.train([bad], trainer2.init_state(), epochs=4)


def test_two_epochs_over_two_buildings(tmp_path):
    """Four real steps on the CPU: finite losses, four applied updates,
    moved parameters, the checkpoints, and a resume that restores them."""
    _, tcfg = cfg_pair()
    trainer = Trainer(tcfg, output_dir=str(tmp_path), device="cpu")
    state = trainer.init_state(seed=0)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    state = trainer.train([tiny_scene(0), tiny_scene(1)], state, epochs=2,
                          checkpoint_period_epochs=1)
    assert state.step == 4 and state.solver.count == 4
    assert trainer.meters.loss.count == 4
    assert np.isfinite(trainer.meters.loss.global_avg)
    assert trainer.meters.loss_objectness.count == 4
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    # weight decay moves every weight; only an unused bias (zero, no
    # gradient, no decay) may stay
    assert all(is_bias(n) and not before[n].any() for n in still), still
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt"))
    assert files == ["model_0000000.pt", "model_0000001.pt",
                     "model_final.pt", "model_min_loss.pt"]
    fresh = trainer.init_state(seed=5)
    fresh.load_state_dict(trainer.checkpointer.load())
    assert fresh.step == 4 and fresh.solver.count == 4
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p.detach(), state.model.state_dict()[n]), n


def test_not_ported_parts_raise(tmp_path, monkeypatch):
    """What the Trainer does not port raises; eval_in_train is ported
    (tests/test_torch_eval_in_train.py) and constructs."""
    _, tcfg = cfg_pair()
    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(tcfg, str(tmp_path), device="cpu", mesh=object())
    Trainer(tcfg.replace(eval_in_train=1), str(tmp_path), device="cpu")
    trainer = Trainer(tcfg, str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="host pyramid packer"):
        trainer.train_resident([tiny_scene(0)], None, 1)

    class Loader:
        def epoch(self, order):
            return iter(())
    with pytest.raises(NotImplementedError, match="loader objects"):
        trainer.train(Loader(), trainer.init_state(), 1)
    trainer.scan_steps = 4
    with pytest.raises(NotImplementedError, match="host packer"):
        trainer.train([tiny_scene(0)], trainer.init_state(), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tcfg, str(tmp_path))
