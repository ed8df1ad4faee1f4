"""The port's spans and host-sync counter (utils/profiling.span), on the
CPU: the null path with no profiler, a span in both the log and the
profiler's events, nesting, the edge rule at the profiler's stop, the
counter fed simulated reports of torch's sync detector, and the spans
that the predict, ``Trainer.step`` and the pipelined ``run_inference``
open. The card's own syncs are counted in
tests/test_torch_tracing_cuda.py.
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detection_3d_tpu_torch.data.packing import pack_table
from detection_3d_tpu_torch.engine.inference import (
    make_batch_predict_fn, make_predict_fn, run_inference)
from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
from detection_3d_tpu_torch.models.detector import SparseRCNN
from detection_3d_tpu_torch.utils import profiling
from detection_3d_tpu_torch.utils.profiling import (
    SYNC_MESSAGE, recorded_spans, span)
from test_torch_common import cfg_pair, tiny_scene

STAGES = ["model.input", "model.pyramid", "model.backbone", "model.rpn",
          "model.roi_head", "model.postprocess"]


@pytest.fixture(autouse=True)
def empty_log():
    """Each test starts and ends with an empty log and the detector off."""
    recorded_spans()
    yield
    recorded_spans()
    assert not profiling._counter.on


@pytest.fixture(scope="module")
def tiny():
    """The suite's tiny config and a model with seeded weights."""
    _, cfg = cfg_pair()
    return cfg, SparseRCNN(cfg, seed=0)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _children(spans, parent):
    return [r.name for r in spans if r.parent == parent.id]


def test_span_without_profiler_logs_nothing():
    assert span("a") is span("b", buildings=3) is profiling._NULL
    with span("a") as s:
        (torch.randn(8, 8) @ torch.randn(8, 8)).sum()
    assert s is None
    assert recorded_spans() == []


def test_span_is_in_the_log_and_the_profiler_events():
    x = torch.randn(64, 64)
    with _profiler() as prof:
        with span("port.region", buildings=2):
            (x @ x).sum()
    (rec,) = recorded_spans()
    assert rec.name == "port.region" and rec.buildings == 2
    assert rec.end_ns > rec.start_ns and rec.seconds > 0
    assert rec.thread == threading.get_ident() and rec.parent is None
    events = prof.events()
    (region,) = [e for e in events if e.name == "port.region"]
    inside = [e for e in events if e.name in ("aten::mm", "aten::sum")]
    assert {e.name for e in inside} == {"aten::mm", "aten::sum"}
    for e in inside:
        assert region.time_range.start <= e.time_range.start
        assert e.time_range.end <= region.time_range.end


def test_nesting_and_parents_are_recorded():
    with _profiler():
        with span("outer"):
            with span("middle"):
                with span("leaf"):
                    pass
            with span("second"):
                pass
    spans = recorded_spans()
    assert [r.name for r in spans] == ["outer", "middle", "leaf", "second"]
    by = {r.name: r for r in spans}
    assert by["outer"].parent is None
    assert by["middle"].parent == by["second"].parent == by["outer"].id
    assert by["leaf"].parent == by["middle"].id
    assert len({r.id for r in spans}) == 4


def test_span_straddling_the_stop_is_not_logged():
    prof = _profiler()
    prof.start()
    with span("whole"):
        pass
    straddle = span("straddle")
    straddle.__enter__()
    prof.stop()
    straddle.__exit__(None, None, None)
    with span("after"):         # no profiler: the null context
        pass
    assert [r.name for r in recorded_spans()] == ["whole"]


def test_sync_counter_credits_the_innermost_span(recwarn, monkeypatch):
    with _profiler():       # a first profile imports sympy: a new filter
        pass
    shown = warnings.showwarning
    filters = list(warnings.filters)
    elsewhere = []

    def other_thread():
        warnings.warn(SYNC_MESSAGE)         # no span open on this thread
        with span("other"):
            warnings.warn(SYNC_MESSAGE)
        elsewhere.append(True)

    with _profiler():
        with span("outer"):
            with span("inner"):
                for _ in range(2):          # one site, two syncs
                    warnings.warn(SYNC_MESSAGE)
            t = threading.Thread(target=other_thread)
            t.start()
            t.join(timeout=30)
            warnings.warn(SYNC_MESSAGE)
    assert not t.is_alive() and elsewhere == [True]
    by = {r.name: r for r in recorded_spans()}
    assert (by["inner"].syncs, by["inner"].syncs_within) == (2, 2)
    assert (by["outer"].syncs, by["outer"].syncs_within) == (1, 3)
    assert (by["other"].syncs, by["other"].syncs_within) == (1, 1)
    # counted, not shown; the hook and the filters are back
    assert not [w for w in recwarn if SYNC_MESSAGE in str(w.message)]
    assert warnings.showwarning is shown and warnings.filters == filters
    # other warnings go on to the display the hook replaced
    seen = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *args: seen.append(str(message)))
    with _profiler():
        with span("plain"):
            warnings.warn("not a sync")
    assert recorded_spans()[0].syncs == 0 and seen == ["not a sync"]


def test_detector_switches_off_at_the_first_span_after_the_stop():
    with _profiler():
        with span("on"):
            assert profiling._counter.on
    assert profiling._counter.on
    with span("off"):
        pass
    assert not profiling._counter.on
    assert [r.name for r in recorded_spans()] == ["on"]


@pytest.mark.parametrize("batched", [False, True])
def test_predict_spans(tiny, batched):
    cfg, model = tiny
    if batched:
        packs = [pack_table(cfg, tiny_scene(s)) for s in (1, 2)]
        batch = {k: np.stack([p[k] for p in packs]) for k in packs[0]}
        predict = make_batch_predict_fn(cfg, model, device="cpu")
    else:
        batch = pad_scene(cfg, tiny_scene(1))
        predict = make_predict_fn(cfg, model, device="cpu")
    with _profiler():
        predict(batch)
    spans = recorded_spans()
    (top,) = [r for r in spans if r.parent is None]
    assert top.name == "model.predict" and top.buildings == (2 if batched
                                                             else 1)
    assert _children(spans, top) == STAGES
    assert all(top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
               for r in spans)


def test_trainer_step_spans(tiny, tmp_path):
    cfg, _ = tiny
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(0)
    with _profiler():
        total, _, ok, _ = trainer.step(state, pad_scene(cfg, tiny_scene(1)),
                                       generator=gen)
    assert np.isfinite(total) and ok
    spans = recorded_spans()
    pad, step = [r for r in spans if r.parent is None]
    assert (pad.name, step.name) == ("data.pad_scene", "train.step")
    assert _children(spans, step) == ["train.forward", "train.backward",
                                      "train.update", "train.fetch"]
    (fwd,) = [r for r in spans if r.name == "train.forward"]
    assert _children(spans, fwd) == ["model.pyramid", "model.backbone",
                                     "model.rpn", "model.roi_head"]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_pipelined_serving_spans(tiny, batch_size):
    cfg, model = tiny
    scenes = [tiny_scene(s) for s in (1, 2, 3)]
    timings = {}
    with _profiler():
        run_inference(cfg, model, scenes, "cpu", pipelined=True,
                      pack_workers=2, pack_mode="table", timings=timings,
                      batch_size=batch_size)
    assert set(timings) == {"wait_pack", "dispatch", "drain_fetch"}
    spans = recorded_spans()
    n_units = -(-len(scenes) // batch_size)
    units = [r for r in spans if r.name == "serve.unit"]
    assert len(units) == n_units
    assert [u.buildings for u in units] == [
        min(batch_size, len(scenes) - i * batch_size)
        for i in range(n_units)]
    for u in units:
        assert u.parent is None
        assert _children(spans, u) == ["serve.wait_pack", "serve.dispatch",
                                       "serve.fetch"]
        (dispatch,) = [r for r in spans if r.parent == u.id
                       and r.name == "serve.dispatch"]
        assert _children(spans, dispatch) == ["model.predict"]
    # the fetch after the loop, outside every unit
    assert [r.name for r in spans if r.parent is None
            and r.name != "serve.unit" and r.thread == units[0].thread] == [
        "serve.fetch"]
    packs = [r for r in spans if r.name == "serve.pack"]
    assert len(packs) == n_units
    assert all(p.thread != units[0].thread for p in packs)
    # the spans lie inside the brackets timings sums
    for key, name in (("wait_pack", "serve.wait_pack"),
                      ("dispatch", "serve.dispatch"),
                      ("drain_fetch", "serve.fetch")):
        inside = sum(r.seconds for r in spans if r.name == name)
        assert 0 < inside <= timings[key] < inside + 0.05, key


def test_trace_holds_the_pack_workers_spans(tiny, tmp_path):
    """``profiling.trace`` records every thread: the workers' packs show
    in its Chrome trace beside the serving loop's units."""
    cfg, model = tiny
    with profiling.trace(str(tmp_path)):
        run_inference(cfg, model, [tiny_scene(s) for s in (1, 2)], "cpu",
                      pipelined=True, pack_workers=1, pack_mode="table")
    recorded_spans()
    events = json.loads((tmp_path / "trace.json").read_text())
    tids = {}
    for e in events["traceEvents"]:
        if e.get("name") in ("serve.pack", "serve.unit"):
            tids.setdefault(e["name"], set()).add(e["tid"])
    assert tids["serve.pack"] and tids["serve.unit"]
    assert not tids["serve.pack"] & tids["serve.unit"]
