"""CUDA graphs over a served unit's forward (engine/inference.GraphedForward).

On the CPU (tier 1): the graph's key (``graph_signature``) changes with
the input form, a shape, a dtype and a rebound weight, and with nothing
else; a CPU predict never captures and opens no ``model.replay`` span;
the bookkeeping of eager, captured and replayed calls (spans, the
launch counters, the replay count, a new signature's graph taking the
old one's place) with a stand-in for torch's graph API; and the gate
that keeps the pack workers' copies out of a capture.

On the card (the ``cuda`` marker; skipped without one): replayed outputs
bit equal to the eager forward's for the table form at B = 4 with a
padded tail unit, the raw form, the points form (``packed=True``), the
pyramid form and 3G6c's table form at B = 2; unit i's outputs unchanged
after unit i+1 replays; a rebound weight captures again; a replay runs
on the card the kernels an eager call launches; a replayed stream unit
makes no host sync; and a capture beside a worker thread copying to the
card. The file imports nothing of
JAX (run the card tests with ``--noconftest``).
"""

import contextlib
import json
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import tiny_3g6c_config, tiny_config, tiny_scene
from detection_3d_tpu_torch.data.packing import (
    pack_scene, pack_table, to_device)
from detection_3d_tpu_torch.data.pyramid_packing import pack_pyramid
from detection_3d_tpu_torch.engine import inference
from detection_3d_tpu_torch.engine.inference import (
    GraphedForward, graph_signature, make_batch_predict_fn, make_predict_fn)
from detection_3d_tpu_torch.engine.trainer import pad_scene
from detection_3d_tpu_torch.models.detector import SparseRCNN
from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.cuda_lib import SYMBOLS
from detection_3d_tpu_torch.utils.profiling import recorded_spans


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    return cfg, SparseRCNN(cfg, seed=0).eval()


def _stacked(packs, unit):
    return {k: np.stack([packs[i][k] for i in unit]) for k in packs[0]}


def _rebind_first_weight(model):
    """Rebind the model's first parameter to new storage, same values."""
    module = next(m for m in model.modules()
                  if next(m.parameters(recurse=False), None) is not None)
    name, p = next(module.named_parameters(recurse=False))
    setattr(module, name, torch.nn.Parameter(p.detach().clone()))


# ---- the key (CPU) ---------------------------------------------------------

def _key_cases():
    """(name, edit, changes): ``edit(packed, inputs, model)`` gives the
    packed form and inputs of a second call, after any edit of the
    model."""
    def rebound(packed, inputs, model):
        _rebind_first_weight(model)
        return packed, inputs

    def in_place(packed, inputs, model):
        with torch.no_grad():
            next(model.parameters()).mul_(2.0)
        return packed, inputs

    def shape(packed, inputs, model):
        k = "points"
        return packed, {**inputs, k: inputs[k][:-1]}

    def dtype(packed, inputs, model):
        k = "feats"
        return packed, {**inputs, k: inputs[k].double()}

    def values(packed, inputs, model):
        return packed, {k: v + 1 if v.dtype != torch.bool else ~v
                        for k, v in inputs.items()}

    def order(packed, inputs, model):
        return packed, dict(reversed(list(inputs.items())))

    return [("form", lambda p, i, m: (True, i), True),
            ("shape", shape, True), ("dtype", dtype, True),
            ("rebound_parameter", rebound, True),
            ("values", values, False), ("key_order", order, False),
            ("in_place_update", in_place, False),
            ("nothing", lambda p, i, m: (p, i), False)]


@pytest.mark.parametrize("name,edit,changes", _key_cases(),
                         ids=[c[0] for c in _key_cases()])
def test_graph_signature_changes_with_form_shape_dtype_and_weights(
        name, edit, changes):
    cfg = tiny_config()
    model = SparseRCNN(cfg, seed=0)
    inputs = inference._inputs(False, pad_scene(cfg, tiny_scene(cfg, 1)))
    key = graph_signature(False, inputs, model)
    packed, inputs2 = edit(False, dict(inputs), model)
    assert (graph_signature(packed, inputs2, model) != key) == changes


def test_raw_inputs_are_the_three_arrays_the_forward_reads():
    cfg = tiny_config()
    batch = pad_scene(cfg, tiny_scene(cfg, 1))
    assert set(batch) > set(inference.RAW_KEYS)
    assert list(inference._inputs(False, batch)) == list(inference.RAW_KEYS)
    packs = pack_table(cfg, tiny_scene(cfg, 1))
    assert list(inference._inputs("table", packs)) == list(packs)


# ---- the CPU path (CPU) ----------------------------------------------------

def _refuse(*args, **kw):
    raise AssertionError("a CPU predict reached torch's CUDA graph API")


@pytest.mark.parametrize("batched", [False, True])
def test_cpu_predict_never_captures(tiny, batched, monkeypatch):
    cfg, model = tiny
    for name in ("CUDAGraph", "graph", "graph_pool_handle"):
        monkeypatch.setattr(torch.cuda, name, _refuse)
    if batched:
        packs = [pack_table(cfg, tiny_scene(cfg, s)) for s in (1, 2)]
        batch = _stacked(packs, [0, 1])
        make = make_batch_predict_fn
    else:
        batch = pad_scene(cfg, tiny_scene(cfg, 1))
        make = make_predict_fn
    predict = make(cfg, model, device="cpu")
    eager = make(cfg, model, device="cpu", graph=False)
    assert predict.graphed is None and eager.graphed is None
    want = eager(batch)
    recorded_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [predict(batch) for _ in range(3)]
    spans = recorded_spans()
    assert [r.name for r in spans].count("model.predict") == 3
    assert "model.replay" not in {r.name for r in spans}
    assert [r.name for r in spans].count("model.backbone") == 3
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, want))


# ---- the bookkeeping, with a stand-in graph (CPU) -------------------------

class _StandInGraph:
    """torch.cuda.CUDAGraph's part GraphedForward uses (the capture
    context, the pool handle and the device guard are stood in too): the
    capture runs the forward once (on the CPU), a replay does nothing, so
    a replay gives the captured call's outputs."""

    made = 0

    def __init__(self):
        _StandInGraph.made += 1
        self.replays = 0

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def _stand_in_capture(graph, pool=None, capture_error_mode=None):
    assert isinstance(graph, _StandInGraph) and pool == "pool"
    assert capture_error_mode == "thread_local"
    yield


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    _StandInGraph.made = 0
    recorded_spans()
    yield
    recorded_spans()


def _counting_forward(monkeypatch, n):
    """Make every forward add ``n`` to kernel A's launch counter, as the
    card's wrappers do when they launch."""
    real = inference._forward

    def forward(model, table, pyramid):
        cuda_lib.launches["gather_conv"] += n
        return real(model, table, pyramid)

    monkeypatch.setattr(inference, "_forward", forward)


def test_eager_then_capture_then_replay(tiny, stand_in, monkeypatch):
    cfg, model = tiny
    _counting_forward(monkeypatch, 38)
    packs = [pack_table(cfg, tiny_scene(cfg, s)) for s in (1, 2)]
    batch = _stacked(packs, [0, 1])
    graphed = GraphedForward(cfg, model, "table", torch.device("cpu"))
    want = make_batch_predict_fn(cfg, model, "cpu", graph=False)(batch)
    counts, names = [], []
    for _ in range(3):
        before = cuda_lib.launches["gather_conv"]
        with torch.inference_mode(), \
                profile(activities=[ProfilerActivity.CPU]):
            out = graphed(batch, 2)
        counts.append(cuda_lib.launches["gather_conv"] - before)
        spans = recorded_spans()
        names.append([r.name for r in spans])
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        (top,) = [r for r in spans if r.parent is None]
        assert top.name == "model.predict" and top.buildings == 2
    # the eager call and the capture call the wrappers, a replay none
    assert counts == [38, 38, 0]
    assert "model.backbone" in names[0] and "model.replay" not in names[0]
    top = ("model.predict", "model.capture", "model.input", "model.replay")
    assert [n for n in names[1] if n in top] == [
        "model.predict", "model.capture", "model.replay"]
    assert names[2] == ["model.predict", "model.input", "model.replay"]
    assert _StandInGraph.made == 1
    captured = graphed.captured
    assert captured.graph.replays == 2 and graphed.replays == 2
    # outputs are clones: the next replay leaves them alone
    assert out[0].data_ptr() != captured.out.data_ptr()


def test_rebound_weight_captures_at_once(tiny, stand_in):
    cfg, _ = tiny
    model = SparseRCNN(cfg, seed=0).eval()
    batch = pad_scene(cfg, tiny_scene(cfg, 1))
    graphed = GraphedForward(cfg, model, False, torch.device("cpu"))
    with torch.inference_mode():
        for _ in range(3):
            graphed(batch, 1)
        assert _StandInGraph.made == 1
        old = graphed.captured
        _rebind_first_weight(model)
        with profile(activities=[ProfilerActivity.CPU]):
            graphed(batch, 1)       # the shapes ran eagerly before
        assert "model.replay" in {r.name for r in recorded_spans()}
        assert _StandInGraph.made == 2 and graphed.captured is not old
        assert graphed.key == graph_signature(
            False, inference._inputs(False, batch), model)


def test_a_new_signature_replaces_the_graph(tiny, stand_in, monkeypatch):
    """One graph a predict: shapes A, then B, then A again each capture
    in the last one's place, the first call of each shapes eager."""
    cfg, model = tiny
    out = (torch.zeros(4, 10), torch.zeros((), dtype=torch.int32))
    eager = []
    monkeypatch.setattr(inference, "_predict_one",
                        lambda *a: eager.append(a[-2]) or out)
    monkeypatch.setattr(inference, "_input_layer", lambda *a: (None, None))
    monkeypatch.setattr(inference, "_forward", lambda *a: out)
    graphed = GraphedForward(cfg, model, False, torch.device("cpu"))
    batch = pad_scene(cfg, tiny_scene(cfg, 1))
    cut = {k: v[:-1] for k, v in batch.items()}
    keys = []
    with torch.inference_mode():
        for b in (batch, batch, batch, cut, cut, batch, batch):
            graphed(b, 1)
            keys.append(graphed.key)
    assert [len(b["points"]) for b in eager] == [len(batch["points"]),
                                                len(cut["points"])]
    assert _StandInGraph.made == 3 and graphed.replays == 5
    assert keys[0] is None and keys[1] == keys[2] == keys[6]
    assert keys[4][1] != keys[1][1] and keys[3] == keys[2]
    assert graphed.key[1] == keys[1][1]


def _wait_until(cond):
    deadline = time.monotonic() + 10
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.001)


def test_capture_gate_keeps_copies_and_captures_apart():
    """A capture waits for the copy under way; a copy that comes while
    the capture waits passes after it."""
    gate = inference._CaptureGate()
    log, release = [], threading.Event()

    def copy(name, hold=None):
        with gate.copy():
            log.append(name)
            if hold is not None:
                assert hold.wait(10)

    def capture():
        with gate.capture():
            log.append("capture")

    first = threading.Thread(target=copy, args=("copy", release))
    first.start()
    _wait_until(lambda: log == ["copy"])
    capturing = threading.Thread(target=capture)
    capturing.start()
    _wait_until(lambda: gate._captures == 1)
    late = threading.Thread(target=copy, args=("late copy",))
    late.start()
    time.sleep(0.05)
    assert log == ["copy"]
    release.set()
    for t in (first, capturing, late):
        t.join(10)
    assert log == ["copy", "capture", "late copy"]
    assert gate._copies == 0 and gate._captures == 0


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def dev():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs capture only there")
    return torch.device("cuda")


def _same(got, want):
    """Bit for bit (a NaN matches a NaN of the same bits)."""
    return all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        for a, b in zip(got, want))


def _differ(got, want):
    """Where two outputs differ, for a failing assertion's message."""
    a, b = got[0].float().cpu(), want[0].float().cpu()
    return (f"NaN {int(a.isnan().sum())} / {int(b.isnan().sum())}, rows "
            f"differing {(a != b).any(-1).nonzero().flatten().tolist()[:8]}, "
            f"true_num {got[1].tolist()} / {want[1].tolist()}")


def _served(case):
    """(config, make, packed form, inputs of each call): the calls run a
    signature eagerly, capture it, then replay it."""
    if case == "table_b4":
        cfg = tiny_config()
        packs = [pack_table(cfg, tiny_scene(cfg, s)) for s in range(6)]
        units = ([0, 1, 2, 3], [4, 5, 5, 5], [0, 1, 2, 3], [4, 5, 5, 5])
        return (cfg, make_batch_predict_fn, "table",
                [_stacked(packs, u) for u in units])
    if case == "raw_b1":
        cfg = tiny_config()
        return (cfg, make_predict_fn, False,
                [pad_scene(cfg, tiny_scene(cfg, s)) for s in (0, 1, 2, 0)])
    if case == "pyramid_b1":
        cfg = tiny_config()
        return (cfg, make_predict_fn, "pyramid",
                [pack_pyramid(cfg, tiny_scene(cfg, s)) for s in (0, 1, 2, 0)])
    if case == "points_b1":
        cfg = tiny_config()
        return (cfg, make_predict_fn, True,
                [pack_scene(cfg, tiny_scene(cfg, s)) for s in (0, 1, 2, 0)])
    cfg = tiny_3g6c_config()
    packs = [pack_table(cfg, tiny_scene(cfg, s)) for s in range(3)]
    return (cfg, make_batch_predict_fn, "table",
            [_stacked(packs, u) for u in ([0, 1], [2, 2], [0, 1], [2, 2])])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["table_b4", "raw_b1", "points_b1",
                                  "pyramid_b1", "3g6c_table_b2"])
def test_replay_bit_equal_to_eager(dev, case):
    """Each call (eager, capture, replays) bit equal to the eager
    forward. The raw and points forms voxelize on the card, where the
    voxels' feature sums (ops/sparse.build_sparse_tensor's
    ``index_add_``) add in the order the atomics land, so two eager
    calls may differ in the last bit: there both sides run torch's
    deterministic algorithms, the graph captured under them."""
    cfg, make, packed, calls = _served(case)
    model = SparseRCNN(cfg, seed=0).to(dev).eval()
    eager = make(cfg, model, dev, packed=packed, graph=False)
    graphed = make(cfg, model, dev, packed=packed)
    torch.use_deterministic_algorithms(packed in (False, True),
                                       warn_only=True)
    try:
        for i, batch in enumerate(calls):
            want = eager(batch)
            got = graphed(batch)
            assert _same(got, want), f"call {i}: {_differ(got, want)}"
            assert bool((got[0][..., 9] > 0.5).any()), "no detection"
    finally:
        torch.use_deterministic_algorithms(False)
    assert graphed.graphed.replays == len(calls) - 1


@pytest.mark.cuda
def test_unit_outputs_survive_the_next_replay(dev):
    """The pipelined order: unit i+1 is dispatched (replayed) before
    unit i's outputs are fetched."""
    cfg, make, packed, calls = _served("table_b4")
    model = SparseRCNN(cfg, seed=0).to(dev).eval()
    eager = make(cfg, model, dev, packed=packed, graph=False)
    graphed = make(cfg, model, dev, packed=packed)
    wants = [tuple(t.cpu() for t in eager(b)) for b in calls]
    graphed(calls[0])
    graphed(calls[1])                   # eager, then the capture
    pending = None
    for i, batch in enumerate(calls + calls):
        out = graphed(batch)
        if pending is not None:
            j, prev = pending
            assert _same((t.cpu() for t in prev), wants[j]), f"unit {j}"
        pending = (i % len(calls), out)


@pytest.mark.cuda
def test_rebound_weight_captures_again_and_follows(dev):
    cfg, make, packed, calls = _served("table_b4")
    model = SparseRCNN(cfg, seed=0).to(dev).eval()
    eager = make(cfg, model, dev, packed=packed, graph=False)
    graphed = make(cfg, model, dev, packed=packed)
    batch = calls[0]
    for _ in range(3):
        old = graphed(batch)
    first = graphed.graphed.captured
    # every weight to new storage, scaled: the outputs move
    for module in list(model.modules()):
        for name, p in list(module.named_parameters(recurse=False)):
            setattr(module, name, torch.nn.Parameter(p.detach() * 1.25))
    got = graphed(batch)
    second = graphed.graphed.captured
    assert second is not first
    want = eager(batch)
    assert _same(got, want), _differ(got, want)
    assert not _same(got, old)
    assert _same(graphed(batch), want)
    # an update in place is read by the same graph
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.8)
    got, want = graphed(batch), eager(batch)
    assert graphed.graphed.captured is second and _same(got, want)


def _calls_ran(calls, path):
    """What each of ``calls`` (predicts, one ``model.predict`` span each)
    ran on the card, from one profile's Chrome trace: for each call,
    (its kernels by name and count, those a graph launch ran, its copy
    and fill count, those a graph launch ran). A device activity is a
    call's when the CUDA API call that launched it lies in the call's
    span. A graph runs a copy or a fill node as a kernel of CUDA's own
    (``memcpy32_post``, ``memset32``): it counts with the copies and
    fills. The profile's first and last calls read low where the
    profiler drops the activities at its edges: take the middle ones."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "model.predict"),
                   key=lambda e: e["ts"])
    assert len(spans) == len(calls)
    out = []
    for sp in spans:
        lo, hi = sp["ts"], sp["ts"] + sp["dur"]
        ran = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and lo <= runtime.get(e["args"].get("correlation"),
                                     {"ts": -1})["ts"] <= hi]
        node = [e["cat"] != "kernel"
                or e["name"].startswith(("memcpy", "memset")) for e in ran]
        graph = ["GraphLaunch" in runtime[e["args"]["correlation"]]["name"]
                 for e in ran]
        kernels = Counter(e["name"] for e, n in zip(ran, node) if not n)
        in_graph = Counter(e["name"] for e, n, g in zip(ran, node, graph)
                           if g and not n)
        out.append((kernels, in_graph, sum(node),
                    sum(n and g for n, g in zip(node, graph))))
    return out


@pytest.mark.cuda
def test_replay_runs_the_eager_launches(dev, tmp_path):
    """A replay calls no kernel wrapper (ops/cuda_lib.launches does not
    move), and its graph runs on the card the kernels an eager call of
    the same unit launches: the same names, each as many times, the
    hand-written ones as many times as the eager call's wrappers
    launched them, and as many copies and fills. Outside the graph the
    replay adds only copies (its inputs in, its outputs out) and at most
    the two fills torch makes before a graph launch."""
    cfg, make, packed, calls = _served("table_b4")
    model = SparseRCNN(cfg, seed=0).to(dev).eval()
    eager = make(cfg, model, dev, packed=packed, graph=False)
    graphed = make(cfg, model, dev, packed=packed)
    units = [to_device(b, dev) for b in calls]
    graphed(units[0])
    graphed(units[1])                   # eager, then the capture
    eager(units[2])                     # warm
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    eager(units[2])
    wrappers = dict(cuda_lib.launches)
    cuda_lib.reset_launches()
    ran = _calls_ran([lambda: eager(units[2]), lambda: eager(units[2]),
                      lambda: graphed(units[2]), lambda: eager(units[2])],
                     tmp_path / "trace.json")
    (want, want_graph, want_nodes, _), (got, got_graph, nodes,
                                        graph_nodes) = ran[1:3]
    assert graphed.graphed.replays == 2
    assert cuda_lib.launches == {k: 3 * n for k, n in wrappers.items()}, \
        "a replay called a wrapper"
    assert wrappers["gather_conv"] > 0 and wrappers["greedy_nms"] == 2
    assert not want_graph and want_nodes
    for name, symbol in SYMBOLS.items():
        assert sum(n for k, n in got_graph.items() if symbol in k) == \
            sum(n for k, n in want.items() if symbol in k), name
    assert got_graph == want, sorted((got_graph - want).items()) + [
        "eager only"] + sorted((want - got_graph).items())
    assert graph_nodes == want_nodes
    # outside the graph: the inputs' copies in and the outputs' out,
    # and the fills of the generator's seed and offset before a launch
    outside = got - got_graph
    assert sum(outside.values()) <= 2 and all(
        "FillFunctor" in k for k in outside), outside
    assert nodes - graph_nodes <= len(units[2]) + 2


@pytest.mark.cuda
def test_replayed_stream_unit_makes_no_host_sync(dev):
    """A unit already on the card, as the pack workers hand it over:
    the copies into the graph's buffers and the replay queue without a
    host sync (torch's sync detector raises on one)."""
    cfg, make, packed, calls = _served("table_b4")
    model = SparseRCNN(cfg, seed=0).to(dev).eval()
    graphed = make(cfg, model, dev, packed=packed)
    units = [to_device(b, dev) for b in calls]
    graphed(units[0])
    graphed(units[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = graphed(units[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = make(cfg, model, dev, packed=packed, graph=False)(units[2])
    assert _same(out, want)


@pytest.mark.cuda
def test_capture_beside_a_copying_pack_worker(dev):
    """A worker thread copies pageable host arrays to the card, as
    run_inference's pack workers do, all through a capture: the capture
    neither fails nor waits on more than the copy under way, and the
    replay is bit equal to eager."""
    cfg, make, packed, calls = _served("table_b4")
    model = SparseRCNN(cfg, seed=0).to(dev).eval()
    graphed = make(cfg, model, dev, packed=packed)
    graphed(calls[0])                   # eager
    copies = inference._DeviceCopies(dev)
    stop, made = threading.Event(), []

    def worker():
        while not stop.is_set():
            copies.put(calls[1])        # pageable: done when it returns
            made.append(1)

    t = threading.Thread(target=worker)
    t.start()
    try:
        _wait_until(lambda: len(made) >= 2)
        got = graphed(calls[1])         # the capture
        torch.cuda.synchronize()
        _wait_until(lambda: len(made) >= 4)
    finally:
        stop.set()
        t.join(30)
    assert graphed.graphed.replays == 1
    want = make(cfg, model, dev, packed=packed, graph=False)(calls[1])
    assert _same(got, want)
