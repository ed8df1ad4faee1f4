"""The port's profiling hooks (detection_3d_tpu_torch/utils/profiling.py,
the torch.profiler counterpart of the JAX package's utils/profiling.py),
on the CPU: a trace file with the port's spans in it, and the memory
statistics' refusal without a card (tests/test_torch_tracing.py holds
the spans and their sync counts)."""

import json

import pytest
import torch

from detection_3d_tpu_torch.utils import profiling


def test_trace_holds_named_regions(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("port_region"):
            (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert "port_region" in names
    events = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "port_region"
               for e in events["traceEvents"])
    assert [r.name for r in profiling.recorded_spans()] == ["port_region"]


def test_device_memory_stats(monkeypatch):
    assert profiling.device_memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.device_memory_stats()


# ---- device_activity: the busy time is the union of the streams --------

# (name, start_us, end_us, stream): a kernel A launch on the serving
# stream and a host-to-device copy on a pack worker's stream that
# overlap by 4 us, then kernel C alone
OVERLAPPING = [("void gather_conv<ConvForward>", 0.0, 10.0, 7),
               ("Memcpy HtoD (Pinned -> Device)", 6.0, 16.0, 13),
               ("rotated_iou_kernel", 20.0, 25.0, 7)]
DISJOINT = [("void gather_conv<ConvForward>", 0.0, 10.0, 7),
            ("Memcpy HtoD (Pinned -> Device)", 10.0, 16.0, 13),
            ("rotated_iou_kernel", 20.0, 25.0, 7)]


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0), ([(0, 10)], 10.0), ([(0, 10), (5, 12)], 12.0),
    ([(5, 12), (0, 10), (20, 25)], 17.0), ([(0, 10), (2, 3), (3, 4)], 10.0),
    ([(0, 10), (10, 12)], 12.0)])
def test_interval_union(intervals, want):
    assert profiling.interval_union(intervals) == want


def test_busy_is_the_union_of_overlapping_streams():
    s = profiling.activity_summary(OVERLAPPING)
    assert s["sum_ms"] == pytest.approx(25e-3)
    assert s["busy_ms"] == pytest.approx(21e-3) and s["busy_ms"] < s["sum_ms"]
    assert s["span_ms"] == pytest.approx(25e-3)
    assert s["idle_share"] == pytest.approx(1 - 21 / 25)
    assert s["memcpy_ms"] == pytest.approx(10e-3)
    assert s["streams"] == 2 and s["device_activities"] == 3
    assert s["port_kernels_ms"]["gather_conv"] == pytest.approx(10e-3)
    assert s["port_kernels_ms"]["rotated_iou"] == pytest.approx(5e-3)
    assert s["port_kernels_ms"]["subm_match"] == 0
    # the port's kernels under their short names, largest first
    assert [label for label, _ in s["top_ms"]] == [
        "A", "Memcpy HtoD (Pinned -> Device)", "C"]


def test_busy_equals_the_sum_when_disjoint():
    s = profiling.activity_summary(DISJOINT)
    assert s["busy_ms"] == pytest.approx(s["sum_ms"]) == pytest.approx(21e-3)
    assert s["idle_share"] == pytest.approx(1 - 21 / 25)
    with pytest.raises(ValueError, match="no device activity"):
        profiling.activity_summary([])


def test_kernel_labels():
    names = {"void gather_conv_kernel<ConvForward, 64>": "A",
             "void gather_conv_kernel<ConvDFeats, 64>": "dFeats",
             "gather_dw_partial_bf16<2, 4>": "dW",
             "gather_dw_reduce<float>": "dW",
             "subm_match_windows": "B", "rotated_iou_kernel": "C",
             "multi_match_kernel": "D", "Memcpy DtoH": "Memcpy DtoH"}
    for name, label in names.items():
        assert profiling.kernel_label(name) == label, name


def test_device_activity_on_the_cpu_measures_nothing(monkeypatch):
    ran = []
    a = profiling.device_activity(lambda: ran.append(1), "cpu")
    assert ran == [1] and a["device"] == "cpu"
    for key in ("busy_ms", "sum_ms", "span_ms", "idle_share", "memcpy_ms",
                "port_kernels_ms", "top_ms"):
        assert a[key] is None, key
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.device_activity(lambda: ran.append(2))
    assert ran == [1]
