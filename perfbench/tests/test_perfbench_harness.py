"""The harness on the CPU: every cell and metric of BENCHMARK.json loads
from its files by name; a cell added as files and entries runs; the
result line has the contract's keys; the check fails the fp8 control
and faults planted in the program's timed path; the import guard."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import guard, harness as run, spec
from perfbench.tests import tiny

torch.set_num_threads(2)
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
DETECTOR = spec.family(spec.ROOT, "sparse_rcnn")
# the repo's own benchmark, and a copy of it with a model of a second
# family added as files and entries (tiny.add_second_family)
CELLS = [("repo", w["name"]) for w in BENCH["workloads"]] + \
    [("added", w["name"]) for w in BENCH["workloads"]] + \
    [("added", tiny.SECOND_CELL)]
METRICS = [("repo", m["name"]) for m in BENCH["per_layer"]] + \
    [("added", "mfu.seg")]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    added = tiny.copy_repo_root(tmp_path_factory.mktemp("added"))
    return {"repo": spec.ROOT, "added": tiny.add_second_family(added)}


def _json(v):
    """``v`` with every tuple a list, as a configuration file holds it."""
    return json.loads(json.dumps(v))


@pytest.mark.parametrize("kind,cell", CELLS)
def test_every_cell_loads_by_name(roots, kind, cell):
    """Each cell's window and family load by name, the family builds
    both of its configurations, each with the file's widths, and the
    cell's limits are numbers the family compares."""
    c = spec.load_cell(cell, roots[kind])
    assert callable(spec.window(c.root, c.traffic["window"]))
    fam = c.family()
    assert fam.program_config(c.config) == fam.program_config(c.config)
    ref = fam.reference_config(c.config)
    assert ref.compute_dtype == "float32"
    assert fam.WIDTHS
    for side in (fam.program_config(c.config), ref):
        for key in fam.WIDTHS:
            want, got = c.config["model"], side
            for part in key.split("."):
                want, got = want[part], getattr(got, part)
            assert _json(got) == want, key
    assert set(c.limits()) <= fam.LIMIT_NAMES
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("kind,metric", METRICS)
def test_every_metric_has_a_reader(roots, kind, metric):
    assert callable(spec.metric_reader(roots[kind], metric))


def test_every_metric_stem_shares_one_reader():
    """A metric ``<stem>.<part>`` without a file of its own reads through
    ``metrics/<stem>.py``."""
    assert spec.metric_reader(spec.ROOT, "idle_share.any_cell").__module__ \
        == spec.metric_reader(spec.ROOT, "idle_share.train").__module__
    with pytest.raises(FileNotFoundError):
        spec.metric_reader(spec.ROOT, "no_such_metric.train")


def test_size_mix_gives_every_seed_the_same_sizes():
    from perfbench.traffic.pool import building_params
    mix = {"pool": 5, "num_points": 500000, "rooms_xy": [5, 5],
           "room": 8.0, "sizes": [{"count": 3, "num_points": 100000,
                                   "rooms_xy": [2, 2]}, {"count": 2}]}
    a, b = building_params(1, mix), building_params(3000000017, mix)
    key = sorted(json.dumps(x, sort_keys=True) for x in a)
    assert key == sorted(json.dumps(x, sort_keys=True) for x in b)
    assert a != b and sum(x["num_points"] == 100000 for x in a) == 3
    assert building_params(1, {k: v for k, v in mix.items()
                               if k != "sizes"}) == [
        {"num_points": 500000, "rooms_xy": [5, 5], "room": 8.0}] * 5
    with pytest.raises(ValueError):
        building_params(1, dict(mix, pool=4))


@pytest.mark.parametrize("kind", ["repo", "added"])
def test_configuration_files_match_the_program(roots, kind):
    """6c_fpn4321 is the program's full-scale configuration, and every
    configuration names a family file of its checkout."""
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    six = json.loads((spec.HERE / "configs/6c_fpn4321.json").read_text())
    assert DETECTOR.program_config(six) == full_scale_config()
    assert six["reduced"] == []
    root = roots[kind]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert spec.family(root, cfg["family"]).LIMIT_NAMES


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _add_mix(repo, window: str):
    """A mix of a new name with ``window``, a cell of it in s_per_step's
    list and a metric of its own, added to the checkout ``repo`` as a
    file and entries."""
    mix = json.loads((repo / "perfbench/traffic/seg_train.json").read_text())
    (repo / "perfbench/traffic/seg_rooms.json").write_text(json.dumps(
        dict(mix, window=window)))
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "minkunet34c.seg_rooms",
                               "config": "minkunet34c",
                               "traffic": "seg_rooms", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "s_per_step":
            m["workloads"].append("minkunet34c.seg_rooms")
    bench["per_layer"].append(
        {"name": "mfu.seg_rooms", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "device", "moves": "s_per_step",
         "workloads": ["minkunet34c.seg_rooms"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_mix_added_as_a_file_maps_by_its_window(tmp_path):
    """make_root maps a cell of a mix it has never seen to the tiny cells
    of the mix's window kind (labelled_train: the train cells)."""
    repo = tiny.copy_repo_root(tmp_path / "repo")
    _add_mix(repo, "labelled_train")
    made = json.loads((tiny.make_root(tmp_path / "tiny", repo)
                       / "BENCHMARK.json").read_text())
    got = {m["name"]: m.get("workloads") for m in made["end_to_end"]
           + made["per_layer"]}
    assert got["mfu.seg_rooms"] == ["tiny.train", "tiny3g.train"]
    assert got["s_per_step"] == ["tiny.train", "tiny3g.train"]


def test_make_root_refuses_an_unknown_window(tmp_path):
    repo = tiny.copy_repo_root(tmp_path / "repo")
    _add_mix(repo, "no_such_window")
    with pytest.raises(ValueError, match="no_such_window"):
        tiny.make_root(tmp_path / "tiny", repo)


KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("cell,trace", [("tiny.stream", 0),
                                        ("tiny.stream", 1),
                                        ("tiny.single", 0),
                                        ("tiny.mixed", 0),
                                        ("tiny.train", 0),
                                        ("tiny3g.train", 0)])
def test_added_cell_runs_with_the_contract_keys(root, cell, trace):
    r = run.run_cell(tiny.args(cell, trace=trace), require_card=False,
                     root=root)
    assert list(r) == KEYS
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    names = {m["name"] for m in json.loads(
        (root / "BENCHMARK.json").read_text())["end_to_end"]
        if cell in m.get("workloads", [cell])}
    if trace:
        # no device trace on the CPU: only the host-clock reading is there
        assert set(r["metrics"]) <= {"mfu.stream", "mfu.single",
                                     "mfu.train"}
    else:
        assert set(r["metrics"]) == names
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    for v in r["compared"].values():
        assert set(v) == {"value", "limit"}


def _fault_half_batch(packed):
    """Half of each unit's buildings left out: no valid detection."""
    out = packed.clone()
    if out.dim() == 3:
        out[out.shape[0] // 2:, :, 9] = 0.0
    else:
        out[out.shape[0] // 2:, 9] = 0.0
    return out


def _fault_altered(packed):
    """An answer altered where it is produced: every box moved 5 cm."""
    out = packed.clone()
    out[..., 0] += 0.05
    return out


@pytest.mark.parametrize("cell", ["tiny.stream", "tiny.single"])
@pytest.mark.parametrize("fault", [_fault_half_batch, _fault_altered])
def test_planted_fault_is_not_correct(root, monkeypatch, cell, fault):
    from detection_3d_tpu_torch.engine import inference
    pack = inference.pack_detections
    monkeypatch.setattr(inference, "pack_detections",
                        lambda det: fault(pack(det)))
    r = run.run_cell(tiny.args(cell), require_card=False, root=root)
    assert r["correct"] is False and r["failed"] > 0


def test_fp8_control_is_not_correct(root):
    """The reference in float8 (the family's control) put in the
    program's place fails the check on three seeds."""
    from perfbench import compare
    cell = spec.load_cell("tiny.stream", root)
    dev = torch.device("cpu")
    for seed in (5, 6, 7):
        r = run.prepare(cell, seed, 0.1, False, dev)
        ref = run.reference_model(r)
        ctl = run.reference_model(r, r.family.control)
        answers = [(b, r.family.reference_answer(r, ctl, b))
                   for b in range(len(r.pool))]
        numbers = compare.worst(run.check(r, answers, ref))
        assert not compare.judge(numbers, cell.limits())[0], numbers


@pytest.mark.parametrize("cell", ["tiny.train", "tiny3g.train"])
@pytest.mark.parametrize("fault", sorted(DETECTOR.FAULTS))
def test_planted_training_fault_is_not_correct(root, monkeypatch, cell,
                                               fault):
    spec.load_cell(cell, root).family().FAULTS[fault](monkeypatch.setattr)
    r = run.run_cell(tiny.args(cell), require_card=False, root=root)
    assert r["correct"] is False and r["failed"] == 1


@pytest.mark.parametrize("cell", ["tiny.train", "tiny3g.train"])
def test_fp8_control_fails_the_training_check(root, cell):
    from perfbench import compare, train
    c = spec.load_cell(cell, root)
    r = run.prepare(c, 5, 0.1, False, torch.device("cpu"))
    run.drive(r)
    r.draws = run.close_window(r)["draws"]
    fam = r.family
    want = fam.reference_steps(r, run.reference_model(r), 3)
    got = fam.reference_steps(r, run.reference_model(r, fam.control), 3)
    numbers = train.numbers(got, want, r.weights)
    assert not compare.judge(numbers, c.limits())[0], numbers


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["detection_3d_tpu_torch.models",
                                    "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["detection_3d_tpu.models", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == [
        "detection_3d_tpu.models", "flax.linen", "jax.numpy", "jaxlib"]


def test_yardstick_imports_nothing_of_the_port():
    assert guard.port_imports_in() == []


def test_a_run_loads_no_jax(root):
    """A whole run in a fresh process loads neither JAX nor the JAX
    package."""
    code = ("import sys; from pathlib import Path; "
            "from perfbench import harness, guard; from perfbench.tests "
            "import tiny; harness.run_cell(tiny.args('tiny.single', seconds=0.5), "
            f"require_card=False, root=Path({str(root)!r})); "
            "print(guard.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
