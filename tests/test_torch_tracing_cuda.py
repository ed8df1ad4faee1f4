"""The port's spans on the card: torch's sync detector counts a planted
host sync exactly once in the span it was made in, and kernel A's
launches lie inside the ``model.backbone`` span on the profiler's clock.
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


def test_kernel_a_launches_inside_the_backbone_span(dev, tmp_path):
    from detection_3d_tpu_torch.config.defaults import small_config
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.engine.inference import make_predict_fn
    from detection_3d_tpu_torch.engine.trainer import pad_scene
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    cfg = small_config()
    predict = make_predict_fn(cfg, SparseRCNN(cfg, seed=0), device=dev)
    scene = synthetic_multiroom(seed=1, num_points=20000, rooms_xy=(1, 1),
                                room=4.0,
                                voxel_scale=cfg.sparse3d.voxel_scale)
    batch = pad_scene(cfg, scene)
    predict(batch)[0].cpu()             # builds the kernels, warms up
    with profiling.trace(str(tmp_path)):
        predict(batch)[0].cpu()
    assert [r.name for r in profiling.recorded_spans()
            if r.name == "model.backbone"] == ["model.backbone"]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and SYMBOLS["gather_conv"] in e.get("name", "")]
    (backbone,) = [e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == "model.backbone"]
    lo, hi = backbone["ts"], backbone["ts"] + backbone["dur"]
    assert kernels
    for k in kernels:
        launch = runtime[k["args"]["correlation"]]
        assert lo <= launch["ts"] and launch["ts"] + launch["dur"] <= hi
