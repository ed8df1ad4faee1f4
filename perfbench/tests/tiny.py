"""A tiny benchmark for the CPU tests: a checkout root with its own
BENCHMARK.json, a small configuration of the same model, two traffic
mixes of small buildings and their limits, added as files and entries
beside copies of the real per-layer readers. The limits were read from
these cells' own runs on the CPU (program and fp8 control, compare.py's
numbers): program at most 0.03 unmatched and 7.4e-4 score gap, the
control 0.28 and 3.4e-3. A second model family (second_family/) is
added to such a root, or to a copy of the repo's own benchmark, as
files and entries alone."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
SECOND_CELL = "tinyunet.seg"
LIMITS = {"unmatched": 0.12}
TRAIN_LIMITS = {"loss": 1e-3, "grad": 1e-3, "change": 1e-3,
                "change_q90": 1e-3}
BUILDINGS = {"pool": 4, "num_points": 6000, "rooms_xy": [1, 1], "room": 4.0}
# the tiny cells of each kind of window, and the kind of each window a
# traffic mix may name: make_root maps a real cell to the tiny cells of
# its mix's window kind, so a mix added as a file with a window named
# here needs no edit
TINY_CELLS = {"stream": ["tiny.stream"],
              "single": ["tiny.single", "tiny.mixed"],
              "train": ["tiny.train", "tiny3g.train"]}
WINDOW_KINDS = {"stream": "stream",
                "single": "single", "single_again": "single",
                "segment": "single",          # second_family/segment.py
                "train": "train", "labelled_train": "train"}


def tiny_model():
    model = json.loads((REPO / "perfbench/configs/6c_fpn4321.json")
                       .read_text())["model"]
    model.update(compute_dtype="float32", backbone_out_channels=16)
    model["sparse3d"].update(
        voxel_scale=50, voxel_full_scale=[512, 512, 256],
        nplanes_front=[8, 16, 16, 32, 32], kernels=[[2, 2, 2]] * 4,
        strides=[[2, 2, 2]] * 4, nplane_map=16)
    model["rpn"].update(
        rpn_scales_from_top=[2, 1], rpn_3d_2d_selector=[0, 1, 2],
        anchor_sizes_3d=[[0.2, 0.5, 3], [0.4, 1.5, 3], [0.6, 2.5, 3]],
        use_yaws=[1, 1, 1], fpn_pre_nms_top_n_train=256,
        fpn_pre_nms_top_n_test=256, fpn_post_nms_top_n_train=64,
        fpn_post_nms_top_n_test=64, batch_size_per_image=64)
    model["roi"].update(pooler_scales_from_top=[2, 1],
                        batch_size_per_image=64, detections_per_img=32,
                        mlp_head_dim=32)
    model["caps"].update(max_points=8192,
                         voxel_caps=[8192, 4096, 2048, 1024, 512], max_gt=32)
    return model


def window_kind(repo: Path, traffic: str) -> str:
    """The kind of window (WINDOW_KINDS) of the traffic mix ``traffic`` of
    the checkout ``repo``; raises ValueError naming a window it does not
    know."""
    window = json.loads((repo / "perfbench" / "traffic"
                         / f"{traffic}.json").read_text())["window"]
    if window not in WINDOW_KINDS:
        raise ValueError(f"traffic mix {traffic!r}: window {window!r} is "
                         f"not one of {sorted(WINDOW_KINDS)}")
    return WINDOW_KINDS[window]


def make_root(root: Path, repo: Path = REPO) -> Path:
    """A checkout root under ``root`` with the tiny cells ``tiny.stream``,
    ``tiny.single``, ``tiny.mixed`` (a window file and a mix of sizes
    added as files), ``tiny.train`` and ``tiny3g.train``, beside the
    readers, windows and families of the checkout ``repo`` and its
    BENCHMARK.json's metrics, each real cell a metric lists replaced by
    the tiny cells of its mix's window kind (:func:`window_kind`);
    returns it."""
    pb = root / "perfbench"
    for d in ("metrics", "windows", "families"):
        shutil.copytree(repo / "perfbench" / d, pb / d)
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True)
    (pb / "configs/tiny.json").write_text(json.dumps(
        {"name": "tiny", "family": "sparse_rcnn", "source": "test",
         "reduced": [], "model": tiny_model()}))
    (pb / "configs/tiny3g.json").write_text(json.dumps(
        {"name": "tiny3g", "family": "sparse_rcnn", "source": "test",
         "reduced": [], "model": dict(tiny_model(),
                       separate_classes=[["wall"], ["ceiling", "floor"]])}))
    (pb / "traffic/tiny_stream.json").write_text(json.dumps(
        {"window": "stream", "buildings": BUILDINGS, "batch_size": 2,
         "pack_workers": 2, "pack_mode": "table", "warm_units": 2,
         "min_units": 4, "sized_rate": 1.0, "profile_units": 2, "check_answers": 3}))
    (pb / "traffic/tiny_single.json").write_text(json.dumps(
        {"window": "single", "buildings": BUILDINGS, "warm_buildings": 1,
         "profile_after": 1, "profile_buildings": 2, "check_answers": 3}))
    # a kind of window and a mix of sizes added as files alone
    shutil.copy(pb / "windows/single.py", pb / "windows/single_again.py")
    (pb / "traffic/tiny_mixed.json").write_text(json.dumps(
        {"window": "single_again", "buildings": dict(
            BUILDINGS, sizes=[{"count": 3},
                              {"count": 1, "num_points": 3000}]),
         "warm_buildings": 1, "profile_after": 1, "profile_buildings": 2,
         "check_answers": 3}))
    (pb / "traffic/tiny_train.json").write_text(json.dumps(
        {"window": "train", "buildings": BUILDINGS, "checked_steps": 3,
         "profile_after": 1, "profile_steps": 2}))
    for c in ("tiny.stream", "tiny.single", "tiny.mixed"):
        (pb / f"limits/{c}.json").write_text(json.dumps({"limits": LIMITS}))
    for c in ("tiny.train", "tiny3g.train"):
        (pb / f"limits/{c}.json").write_text(json.dumps(
            {"limits": TRAIN_LIMITS}))
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    kinds = {w["name"]: window_kind(repo, w["traffic"])
             for w in bench["workloads"]}
    bench["configs"] = [{"name": n, "source": "test",
                         "file": f"perfbench/configs/{n}.json",
                         "reduced": [], "why": "test"}
                        for n in ("tiny", "tiny3g")]
    bench["workloads"] = [
        {"name": "tiny.stream", "config": "tiny", "traffic": "tiny_stream",
         "chips": 1, "why": "test"},
        {"name": "tiny.single", "config": "tiny", "traffic": "tiny_single",
         "chips": 1, "why": "test"},
        {"name": "tiny.mixed", "config": "tiny", "traffic": "tiny_mixed",
         "chips": 1, "why": "test"},
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "test"},
        {"name": "tiny3g.train", "config": "tiny3g", "traffic": "tiny_train",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({c for w in m["workloads"]
                                     for c in TINY_CELLS[kinds[w]]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def copy_repo_root(root: Path) -> Path:
    """A checkout root under ``root`` holding the repo's own
    BENCHMARK.json and the benchmark's files that it names; returns
    it."""
    for d in ("configs", "traffic", "limits", "windows", "families",
              "metrics"):
        shutil.copytree(REPO / "perfbench" / d, root / "perfbench" / d)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def add_second_family(root: Path) -> Path:
    """The segmenting family (second_family/tiny_unet.py), its
    configuration, a mix with its window, limits and their entries,
    added to the checkout ``root`` (make_root or copy_repo_root) as the
    cell SECOND_CELL; returns ``root``."""
    pb = root / "perfbench"
    shutil.copy(HERE / "second_family/tiny_unet.py",
                pb / "families/tiny_unet.py")
    shutil.copy(HERE / "second_family/segment.py", pb / "windows/segment.py")
    (pb / "configs/tinyunet.json").write_text(json.dumps(
        {"name": "tinyunet", "family": "tiny_unet", "source": "test",
         "reduced": [], "model": {
             "classes": tiny_model()["classes"], "num_classes": 5,
             "in_channels": 6, "nplanes": [8, 8], "caps": [8192, 4096],
             "max_points": 8192, "voxel_full_scale": [512, 512, 256],
             "compute_dtype": "float32"}}))
    (pb / "traffic/tiny_seg.json").write_text(json.dumps(
        {"window": "segment", "buildings": BUILDINGS,
         "warm_buildings": 1, "profile_after": 1, "profile_buildings": 2,
         "check_answers": 3}))
    # on the CPU the program reads 0 (seeds 1-3, 3000000017: the same
    # arithmetic), the planted faults 0.010-1.0, the control 0.10-0.16
    (pb / f"limits/{SECOND_CELL}.json").write_text(json.dumps(
        {"limits": {"logit_gap": 1e-4}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyunet", "source": "test",
                             "file": "perfbench/configs/tinyunet.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": SECOND_CELL, "config": "tinyunet",
                               "traffic": "tiny_seg", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "latency_p95_s":
            m["workloads"].append(SECOND_CELL)
    bench["per_layer"].append(
        {"name": "mfu.seg", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "device",
         "moves": "latency_p95_s", "workloads": [SECOND_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def args(workload: str, seed: int = 3000000017, trace: int = 0,
         seconds: float = 2.0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
