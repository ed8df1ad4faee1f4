"""The ``replay_share`` reader (metrics/replay_share.py) on hand-made span
logs: replayed buildings over served ones, only replays inside a logged
``model.predict`` counted, and None without a sub-window, without a
replay (a program without CUDA graphs) or without a log."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from detection_3d_tpu_torch.utils.profiling import SpanRecord
from perfbench import spec

MS = 1_000_000      # ns


def _rec(name, start_ms, end_ms, id, parent=None, buildings=None):
    return SpanRecord(name, 1, start_ms * MS, end_ms * MS, id, parent,
                      buildings, 0, 0)


# an eager unit of 4, two replayed units of 4 and one replay whose
# predict straddled the sub-window's start (not logged)
LOG = [
    _rec("model.predict", 0, 50, 1, buildings=4),
    _rec("model.input", 0, 5, 2, parent=1),
    _rec("model.backbone", 5, 30, 3, parent=1),
    _rec("model.predict", 60, 70, 4, buildings=4),
    _rec("model.input", 60, 61, 5, parent=4),
    _rec("model.replay", 61, 70, 6, parent=4, buildings=4),
    _rec("model.predict", 80, 90, 7, buildings=4),
    _rec("model.replay", 81, 90, 8, parent=7, buildings=4),
    _rec("model.replay", 95, 99, 10, parent=9, buildings=4),
]


def _run(log, sub=True):
    return SimpleNamespace(sub={"window_s": 1.0} if sub else None,
                           spans=log)


@pytest.mark.parametrize("metric", ["replay_share.stream",
                                    "replay_share.single"])
def test_replay_share_on_a_hand_made_log(metric):
    read = spec.metric_reader(spec.ROOT, metric)
    assert read(_run(LOG)) == pytest.approx(100.0 * 8 / 12)
    every = [r for r in LOG if r.name != "model.backbone"
             and r.id not in (1, 2, 10)]
    assert read(_run(every)) == pytest.approx(100.0)


@pytest.mark.parametrize("log,sub", [
    (LOG, False),
    ([r for r in LOG if r.name != "model.replay"], True),
    ([], True),
    (None, True)])
def test_replay_share_gives_none_where_nothing_replayed(log, sub):
    read = spec.metric_reader(spec.ROOT, "replay_share.stream")
    assert read(_run(log, sub)) is None
