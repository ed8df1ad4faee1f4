"""The port's profiling hooks (detection_3d_tpu_torch/utils/profiling.py,
the torch.profiler counterpart of the JAX package's utils/profiling.py),
on the CPU: a trace file with the named regions in it, the step timer,
and the memory statistics' refusal without a card."""

import json

import pytest
import torch

from detection_3d_tpu_torch.utils import profiling


def test_trace_holds_named_regions(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.named_scope("port_region"):
            (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert "port_region" in names
    events = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "port_region"
               for e in events["traceEvents"])


def test_step_timer():
    t = profiling.StepTimer()
    t.start()
    y = torch.randn(128, 128) @ torch.randn(128, 128)
    dt = t.stop(y, torch.zeros(3))
    assert dt > 0 and t.t0 is None


def test_device_memory_stats(monkeypatch):
    assert profiling.device_memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.device_memory_stats()
