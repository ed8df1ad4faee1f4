"""scan_steps and train_resident on the CPU.

``Trainer.scan`` runs K steps with no host fetch between them, each
gated on the device (engine/solver.py): it must equal K single steps bit
for bit (losses, parameters, momentum, the solver clock), with a
non-finite scene as the very first step of a run and inside the chunk;
``train(scan_steps=2)`` must give the single-step history. The port's
CLI trains with ``--scan-steps 2``.

``train_resident`` packs each scene once and trains in chunks of packed
steps: its step order is the JAX trainer's formula (a permutation per
epoch from ``default_rng(seed + 77)``, cycle-padded to a chunk
multiple, also when the pad exceeds the order); each chunk draws from
its own (seed, chunk) generator, so a run resumed at a chunk boundary
equals the uninterrupted run bit for bit; a resume step that is not a
chunk multiple raises.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from detection_3d_tpu.engine.trainer import cycle_pad as jax_cycle_pad
from detection_3d_tpu_torch.engine.trainer import (
    Trainer, chunk_generator, pad_scene)
from detection_3d_tpu_torch.models.detector import SparseRCNN
from test_torch_common import cfg_pair, tiny_scene
from test_torch_train_net import ROOT, TINY_OPTS, _write_yaml


def _same(a, b):
    """Equal host numbers, NaN equal to NaN."""
    return a == b or (np.isnan(a) and np.isnan(b))


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for (t1, l1, ok1, n1), (t2, l2, ok2, n2) in zip(got, want):
        assert _same(t1, t2) and ok1 == ok2 and n1 == n2
        assert l1.keys() == l2.keys()
        assert all(_same(l1[k], l2[k]) for k in l1)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.solver.count == b.solver.count
    for (n, p), q in zip(a.model.named_parameters(),
                         b.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(a.solver.optimizer.state[p]["momentum_buffer"],
                           b.solver.optimizer.state[q]["momentum_buffer"]), n


def test_scan_equals_single_steps(tmp_path):
    """A non-finite step first (before any update) and one inside the
    chunk: both change nothing, on either path."""
    _, tcfg = cfg_pair()
    bad = pad_scene(tcfg, tiny_scene(2))
    bad["feats"][:] = np.nan
    batches = [bad, pad_scene(tcfg, tiny_scene(0)), bad,
               pad_scene(tcfg, tiny_scene(1))]
    trainer = Trainer(tcfg, output_dir=str(tmp_path), device="cpu")
    base = SparseRCNN(tcfg, seed=0)
    single = trainer.init_state(model=copy.deepcopy(base))
    scanned = trainer.init_state(model=copy.deepcopy(base))
    g1 = torch.Generator().manual_seed(7)
    want = [trainer.step(single, b, g1) for b in batches]
    assert [r[2] for r in want] == [False, True, False, True]
    got = trainer.scan(scanned, batches, torch.Generator().manual_seed(7))
    _assert_results_equal(got, want)
    _assert_states_equal(scanned, single)
    assert single.solver.count == 2 and single.step == 4


def test_train_with_scan_steps_equals_single_steps(tmp_path):
    _, tcfg = cfg_pair()
    runs = []
    for k in (1, 2):
        trainer = Trainer(tcfg, output_dir=str(tmp_path / str(k)),
                          device="cpu")
        trainer.scan_steps = k
        state = trainer.train([tiny_scene(0), tiny_scene(1)],
                              trainer.init_state(seed=0), epochs=2, seed=1)
        runs.append((trainer, state))
    (t1, s1), (t2, s2) = runs
    _assert_results_equal([h[:3] + (0,) for h in t2.history],
                          [h[:3] + (0,) for h in t1.history])
    _assert_states_equal(s2, s1)
    assert len(t2.history) == 4 and t2.meters.loss.count == 4
    assert os.path.exists(tmp_path / "2" / "model_min_loss.pt")


def test_cli_trains_with_scan_steps(tmp_path):
    path, out = _write_yaml(tmp_path)
    # one thread: the test workers share the cores with this process
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "detection_3d_tpu_torch.tools.train_net",
         "--config-file", str(path), "--synthetic", "2", "--device", "cpu",
         "--scan-steps", "2", "--skip-test", *TINY_OPTS], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    saved = torch.load(out / "model_final.pt", weights_only=False)
    assert saved["step"] == 2 and saved["optimizer"]["count"] == 2


# ---- train_resident ------------------------------------------------------


def _fake_scan(trainer, seen):
    """Record which packed scene each step of a chunk gets, and the
    chunk generator's state; advance the step count; finite results."""
    def scan(state, batches, generator=None, packed=False):
        assert packed == "pyramid"
        seen.append(([trainer._scene_of[id(b)] for b in batches],
                     generator.get_state()))
        state.step += len(batches)
        return [(1.0 + 0.01 * i, {"loss_objectness": 1.0}, True, 100)
                for i in range(len(batches))]
    return scan


def _record_packs(monkeypatch, trainer):
    """Name each packed dict on the device by the scene it came from."""
    from detection_3d_tpu_torch.data import native_packer, packing
    pack, to_device = native_packer.pack_pyramid_native, packing.to_device
    trainer._scene_of = {}

    def pack_named(cfg, scene, *a, **kw):
        return dict(pack(cfg, scene, *a, **kw), scene_id=scene["scene_id"])

    def to_device_named(packed, dev, non_blocking=False):
        out = to_device(packed, dev, non_blocking)
        trainer._scene_of[id(out)] = int(packed["scene_id"])
        return out
    monkeypatch.setattr(native_packer, "pack_pyramid_native", pack_named)
    monkeypatch.setattr(packing, "to_device", to_device_named)


@pytest.mark.parametrize("n,epochs,chunk", [(3, 3, 4), (2, 3, 20)])
def test_resident_order_is_the_jax_formula(tmp_path, monkeypatch, n,
                                           epochs, chunk):
    """(3, 3, 4): 9 steps padded to 12; (2, 3, 20): the pad exceeds the
    order (JAX tests/test_train_resident.py:57-72)."""
    _, tcfg = cfg_pair()
    trainer = Trainer(tcfg, output_dir=str(tmp_path), device="cpu")
    _record_packs(monkeypatch, trainer)
    seen = []
    trainer.scan = _fake_scan(trainer, seen)
    scenes = [dict(tiny_scene(i), scene_id=i) for i in range(n)]
    state = trainer.train_resident(scenes, trainer.init_state(seed=0),
                                   epochs, seed=5, chunk=chunk,
                                   checkpoint_every_chunks=2)
    rng = np.random.default_rng(5 + 77)
    want = jax_cycle_pad([int(i) for _ in range(epochs)
                          for i in rng.permutation(n)], chunk)
    assert len(want) % chunk == 0 and len(want) >= n * epochs
    assert [i for ids, _ in seen for i in ids] == want
    assert trainer.resident_order == want
    assert state.step == len(want) and np.isfinite(trainer.min_loss)
    for c, (_, gen_state) in enumerate(seen):
        assert torch.equal(gen_state,
                           chunk_generator(5, c, "cpu").get_state())
    assert trainer.resident_bytes > 0
    files = set(os.listdir(tmp_path))
    assert "model_min_loss.pt" in files
    assert ("model_resident_last.pt" in files) == (len(seen) >= 2)


def test_resident_resume_equals_the_uninterrupted_run(tmp_path):
    _, tcfg = cfg_pair()
    scenes = [tiny_scene(0), tiny_scene(1)]
    base = SparseRCNN(tcfg, seed=0)

    def trainer(name):
        return Trainer(tcfg, output_dir=str(tmp_path / name), device="cpu")

    whole = trainer("whole")
    s_whole = whole.train_resident(
        scenes, whole.init_state(model=copy.deepcopy(base),
                                 iters_per_epoch=2), epochs=2, chunk=2)
    assert s_whole.step == 4 and len(whole.history) == 4
    # the first epoch's order is the first chunk of the two-epoch run
    first = trainer("first")
    first.train_resident(scenes, first.init_state(
        model=copy.deepcopy(base), iters_per_epoch=2), epochs=1, chunk=2,
        checkpoint_every_chunks=1)
    saved = torch.load(tmp_path / "first" / "model_resident_last.pt",
                       weights_only=False)
    assert saved["step"] == 2
    resumed = trainer("resumed")
    state = resumed.init_state(seed=9, iters_per_epoch=2)
    state.load_state_dict(saved)
    state = resumed.train_resident(scenes, state, epochs=2, chunk=2)
    assert len(resumed.history) == 2
    _assert_results_equal([h[:3] + (0,) for h in resumed.history],
                          [h[:3] + (0,) for h in whole.history[2:]])
    _assert_states_equal(state, s_whole)


def test_resident_resume_off_a_chunk_boundary_raises(tmp_path):
    _, tcfg = cfg_pair()
    trainer = Trainer(tcfg, output_dir=str(tmp_path), device="cpu")
    state = trainer.init_state(seed=0)
    state.step = 3
    with pytest.raises(ValueError, match="not a multiple"):
        trainer.train_resident([tiny_scene(0)], state, epochs=4, chunk=2)
