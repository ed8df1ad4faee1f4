"""The port's twin of bench.py (detection_3d_tpu_torch/tools/bench.py) on
the CPU, against the JAX package.

1. small_config() equals bench.py's field for field.
2. At the tiny config (tests/test_torch_common.tiny_cfg) with the same
   weights (JAX's init, converted), the stream's detections over three
   tiny buildings, in "table" and in "pyramid" mode, equal the JAX
   package's run_inference(pipelined=True, pack_mode=mode) as sets: the
   valid rows sorted by (label, score), labels equal, boxes and scores
   within 1e-4 (as tests/test_torch_packed_inference.py holds one
   predict).
3. The JSON line has every key of bench.py's (bench.py:364-391) and the
   port's additions; on the CPU the device fields are null and
   ``device`` is "cpu".
4. The parity checks pass on the CPU at the tiny config. (Without a
   card the tool raises unless given ``--device cpu``:
   tests/test_torch_no_jax.py.)
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

import bench as jbench
from detection_3d_tpu.engine.inference import run_inference as j_run
from detection_3d_tpu.models.detector import SparseRCNN as JRCNN
from detection_3d_tpu_torch.config.defaults import small_config
from detection_3d_tpu_torch.models.detector import SparseRCNN
from detection_3d_tpu_torch.tools import bench
from test_torch_common import cfg_pair, scene_tables, tiny_scene, to_numpy_tree

# the keys of bench.py's JSON line, bench.py:364-391 (its optional
# batch_throughput_note records a caught failure; the twin catches none)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "device_s",
              "stream_mode", "stream_table_s", "stream_pyramid_s",
              "stream_wait_pack_s", "stream_dispatch_s",
              "stream_drain_fetch_s", "host_pack_pyramid_s", "host_cpus",
              "batch_throughput_bps", "batch_size")
ADDED_KEYS = ("device", "power_limit_w", "idle_share", "peak_gib",
              "n_buildings")


def test_small_config_is_the_bench_config():
    assert dataclasses.asdict(small_config()) == \
        dataclasses.asdict(jbench.small_config())


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = cfg_pair()
    jt, _ = scene_tables(jcfg, tcfg)
    params = to_numpy_tree(jax.jit(
        lambda k: JRCNN(jcfg).init(k, jt, is_train=False))(
            jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, SparseRCNN(tcfg).load_jax_params(params)


@pytest.fixture(scope="module")
def bench_run(weights):
    """The twin's default run on the CPU: the held-out building 0, three
    streamed buildings, batch size 2."""
    _, tcfg, _, model = weights
    scenes = [tiny_scene(s) for s in (1, 2, 3)]
    line, streamed = bench.run(tcfg, model, tiny_scene(0), scenes, "cpu",
                               batch_sizes=(2,))
    return scenes, line, streamed


def _rows(pred):
    a = np.concatenate([pred["boxes"], pred["scores"][:, None],
                        pred["labels"][:, None].astype(np.float32)], 1)
    return a[np.lexsort((a[:, 7], a[:, 8]))]


@pytest.mark.parametrize("mode", ["table", "pyramid"])
def test_stream_detections_match_jax(weights, bench_run, mode):
    jcfg, _, params, _ = weights
    scenes, _, streamed = bench_run
    want, _, _ = j_run(jcfg, params, scenes, evaluate=False, pipelined=True,
                       pack_mode=mode)
    got = streamed["preds"][mode]
    assert len(got) == len(want) == len(scenes)
    for g, w in zip(got, want):
        g, w = _rows(g), _rows(w)
        assert w.shape[0] > 0 and g.shape == w.shape
        np.testing.assert_array_equal(g[:, 8], w[:, 8])
        np.testing.assert_allclose(g[:, :8], w[:, :8], atol=1e-4, rtol=0)
    # the batched run serves the same detections as the table mode
    for g, w in zip(streamed["preds"]["batch_2"], streamed["preds"]["table"]):
        np.testing.assert_allclose(_rows(g), _rows(w), atol=1e-6, rtol=0)


def test_line_has_every_bench_key(bench_run):
    scenes, line, streamed = bench_run
    assert bench.LINE_KEYS == BENCH_KEYS
    for key in BENCH_KEYS + ADDED_KEYS + ("launches",):
        assert key in line, key
    assert line["metric"] == "e2e_sec_per_building_fullscale_stream"
    assert line["unit"] == "s" and line["n_buildings"] == len(scenes)
    assert line["device"] == "cpu"
    for key in ("device_s", "idle_share", "peak_gib", "power_limit_w"):
        assert line[key] is None, key
    assert line["stream_mode"] in ("table", "pyramid")
    assert line["value"] == min(line["stream_table_s"],
                                line["stream_pyramid_s"])
    assert line["vs_baseline"] == pytest.approx(4.75 / line["value"])
    assert line["batch_size"] in (1, 2) and line["batch_throughput_bps"] > 0
    for key in ("stream_wait_pack_s", "stream_dispatch_s",
                "stream_drain_fetch_s", "host_pack_pyramid_s"):
        assert line[key] >= 0, key
    assert set(streamed["launches"]) == {"table", "pyramid", "batch_2"}
    # the plain kernels on the CPU launch nothing
    assert not any(n for ln in streamed["launches"].values()
                   for n in ln.values())


def test_small_and_parity_exclude_each_other():
    with pytest.raises(SystemExit):
        bench.main(["--small", "--parity"])


def test_parity_passes_on_the_cpu(weights, capsys):
    _, tcfg, _, _ = weights
    assert bench.parity(tcfg, tiny_scene(0), "cpu") == []
    out = capsys.readouterr().out
    assert out.count(": OK") == 12 and "MISMATCH" not in out
