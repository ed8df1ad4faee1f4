"""The port's spans on the card: torch's sync detector counts a planted
host sync exactly once in the span it was made in, and kernel A's
launches lie inside the ``model.backbone`` span on the profiler's clock
(an eager predict) or inside ``model.replay`` (a replayed CUDA graph).
Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false; the file imports nothing of JAX
(run it with ``--noconftest`` beside tests/test_torch_kernels_cuda.py).
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detection_3d_tpu_torch.ops.cuda_lib import SYMBOLS
from detection_3d_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch's sync detector and kernel A "
                    "run only on the GPU")
    profiling.recorded_spans()
    yield torch.device("cuda")
    profiling.recorded_spans()


@pytest.mark.parametrize("sync", ["item", "cpu"])
def test_planted_sync_counts_once(dev, sync):
    x = torch.arange(1000, dtype=torch.float32, device=dev)
    y = (x * 2).sum()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profiling.span("outer"):
            with profiling.span("planted"):
                z = y.item() if sync == "item" else y.cpu()
            w = x + 1                  # queues, waits for nothing
    by = {r.name: r for r in profiling.recorded_spans()}
    assert float(z) == 999000.0 and w.shape == x.shape
    assert by["planted"].syncs == 1
    assert (by["outer"].syncs, by["outer"].syncs_within) == (0, 1)
    assert torch.cuda.get_sync_debug_mode() == 0


def _traced_predict(dev, tmp_path, graph):
    """One more predict of a small building, traced after ``graph``'s
    warm-up (eager, then the capture when replaying): (the span names,
    the Chrome trace's events)."""
    from detection_3d_tpu_torch.config.defaults import small_config
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.engine.inference import make_predict_fn
    from detection_3d_tpu_torch.engine.trainer import pad_scene
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    cfg = small_config()
    predict = make_predict_fn(cfg, SparseRCNN(cfg, seed=0), device=dev,
                              graph=graph)
    scene = synthetic_multiroom(seed=1, num_points=20000, rooms_xy=(1, 1),
                                room=4.0,
                                voxel_scale=cfg.sparse3d.voxel_scale)
    batch = pad_scene(cfg, scene)
    for _ in range(2 if graph else 1):
        predict(batch)[0].cpu()         # builds the kernels, warms up
    with profiling.trace(str(tmp_path)):
        predict(batch)[0].cpu()
    names = [r.name for r in profiling.recorded_spans()]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return names, events


def _kernel_a_launched_inside(events, span_name):
    """Every kernel A activity's launch (its runtime call, by the
    correlation id: ``cudaLaunchKernel``, or the ``cudaGraphLaunch`` of
    a replay) lies inside the one ``span_name`` range."""
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and SYMBOLS["gather_conv"] in e.get("name", "")]
    (outer,) = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == span_name]
    lo, hi = outer["ts"], outer["ts"] + outer["dur"]
    assert kernels
    for k in kernels:
        launch = runtime[k["args"]["correlation"]]
        assert lo <= launch["ts"] and launch["ts"] + launch["dur"] <= hi
    return kernels


def test_kernel_a_launches_inside_the_backbone_span(dev, tmp_path):
    names, events = _traced_predict(dev, tmp_path, graph=False)
    assert [n for n in names if n == "model.backbone"] == ["model.backbone"]
    assert "model.replay" not in names
    _kernel_a_launched_inside(events, "model.backbone")


def test_kernel_a_launches_inside_the_replay_span(dev, tmp_path):
    """A replayed predict: one ``model.replay`` span, no stage span, and
    kernel A's activities launched by the graph inside the replay."""
    names, events = _traced_predict(dev, tmp_path, graph=True)
    assert [n for n in names if n.startswith("model.")] == [
        "model.predict", "model.input", "model.replay"]
    kernels = _kernel_a_launched_inside(events, "model.replay")
    _, eager_events = _traced_predict(dev, tmp_path / "eager",
                                                graph=False)
    assert len(kernels) == len([e for e in eager_events
                                if e.get("cat") == "kernel"
                                and SYMBOLS["gather_conv"] in e.get("name",
                                                                    "")])
