"""The span readers (perfbench/spans.py, metrics/syncs_per_building.py,
syncs_per_step.py, pad_share.py, dispatch_share.py) on hand-made runs
with a span log, without a sub-window, and on the program's own log."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from detection_3d_tpu_torch.utils.profiling import SpanRecord, recorded_spans
from perfbench import spans, spec
from perfbench.tests.tiny import tiny_model

MS = 1_000_000      # ns


def _rec(name, start_ms, end_ms, id, parent=None, buildings=None,
         syncs=0, syncs_within=None):
    return SpanRecord(name, 1, start_ms * MS, end_ms * MS, id, parent,
                      buildings, syncs,
                      syncs if syncs_within is None else syncs_within)


# two served units of 4 buildings and one logged in part (its unit
# straddled the sub-window's stop), two steps, three pads
LOG = [
    _rec("serve.unit", 0, 100, 1, buildings=4),
    _rec("serve.dispatch", 10, 40, 2, parent=1),
    _rec("model.predict", 10, 40, 3, parent=2, buildings=4, syncs=1,
         syncs_within=6),
    _rec("model.input", 10, 12, 4, parent=3, syncs=5),
    _rec("serve.unit", 100, 300, 5, buildings=4),
    _rec("serve.dispatch", 120, 170, 6, parent=5),
    _rec("model.predict", 120, 170, 7, parent=6, buildings=4,
         syncs_within=2),
    _rec("model.predict", 300, 330, 9, parent=8, buildings=4,
         syncs_within=4),
    _rec("data.pad_scene", 400, 415, 10),
    _rec("data.pad_scene", 500, 520, 11),
    _rec("train.step", 415, 500, 12, syncs=2, syncs_within=30),
    _rec("train.step", 520, 600, 13, syncs_within=34),
    _rec("data.pad_scene", 600, 605, 14),
]
WANT = {"syncs_per_building.single": (6 + 2 + 4) / 12,
        "syncs_per_building.stream": (6 + 2 + 4) / 12,
        "syncs_per_step.train": (30 + 34) / 2,
        "pad_share.single": 100.0 * 0.040 / 2.0,
        "pad_share.train": 100.0 * 0.040 / 2.0,
        "dispatch_share.stream": 100.0 * (30 + 50) / (100 + 200)}


def _run(log, sub=True):
    return SimpleNamespace(sub={"window_s": 2.0} if sub else None,
                           spans=log)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_a_hand_made_log(metric):
    read = spec.metric_reader(spec.ROOT, metric)
    assert read(_run(LOG)) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_gives_none_without_a_sub_window_or_a_span(metric):
    read = spec.metric_reader(spec.ROOT, metric)
    assert read(_run(LOG, sub=False)) is None
    assert read(_run([])) is None
    assert read(_run(None)) is None     # a program that keeps no log


def test_readers_share_the_program_log_read_once():
    """The program's own log, drained once for every reader of a run."""
    from detection_3d_tpu_torch.config.defaults import Config
    from detection_3d_tpu_torch.engine.trainer import pad_scene
    cfg = spec.build_config(Config, {"model": tiny_model()})
    scene = {"points": np.zeros((10, 3), np.float32),
             "feats": np.zeros((10, cfg.in_channels), np.float32),
             "gt_boxes": np.zeros((2, 7), np.float32),
             "gt_labels": np.ones((2,), np.int32)}
    recorded_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        pad_scene(cfg, scene)
        pad_scene(cfg, scene)
    run = SimpleNamespace(sub={"window_s": 2.0})
    share = spans.pad_share(run)
    assert len(run.spans) == 2 and share > 0
    assert spans.pad_share(run) == share       # kept, not drained again
    assert spans.syncs_per_step(run) is None
    assert recorded_spans() == []
