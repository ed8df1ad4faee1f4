"""The MinkUNet family (families/minkunet.py) on the CPU: the repo's
BENCHMARK.json is the benchmark without it plus its entries, wherever
they sit, and so is a copy with a second family appended after it; its
cell runs through harness.run_cell at a small
size (a copy of the repo's root with the configuration cut to an eighth
of its widths and its mix to small buildings); its check fails
each planted fault of the family's FAULTS and the float8 control; the
new readers (metrics/B_roofline.py, plan_share.py) on hand-made runs,
and the BN sites the family counts."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from perfbench import compare, harness as run, spec, train
from perfbench.tests import tiny

torch.set_num_threads(2)
CELL = "minkunet34c.seg_train"
CONFIG = "minkunet34c"
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


MINK_METRICS = {f"{m}.seg_train" for m in (
    "A_roofline", "Abwd_roofline", "B_roofline", "BN_roofline", "plan_share",
    "syncs_per_step", "mfu", "idle_share")}


def _without_family(bench, config, cell):
    """``bench`` with a family's configuration, its cell and the metrics
    that only its cell reports taken out, and its cell out of every
    list."""
    out = json.loads(json.dumps(bench))
    out["configs"] = [c for c in out["configs"] if c["name"] != config]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != cell]
    out["per_layer"] = [m for m in out["per_layer"]
                        if m.get("workloads") != [cell]]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != cell]
    return out


def assert_came_as_entries(bench, config, cell, metrics, e2e):
    """The family of ``config`` came to ``bench`` as entries alone,
    wherever they sit: its configuration and its cell are there once,
    the metrics that list its cell are ``metrics`` and list it alone, the
    end-to-end metric ``e2e`` lists it, and what is left without the
    family (every other entry as ``bench`` holds it, in the same order)
    stands as a benchmark: each cell's configuration is there and each
    metric lists cells that are there."""
    assert [c["name"] for c in bench["configs"]].count(config) == 1
    assert [w["name"] for w in bench["workloads"]].count(cell) == 1
    mine = [m for m in bench["per_layer"] if cell in m.get("workloads", ())]
    assert {m["name"] for m in mine} == metrics
    assert all(m["workloads"] == [cell] for m in mine)
    assert cell in next(m for m in bench["end_to_end"]
                        if m["name"] == e2e)["workloads"]
    before = _without_family(bench, config, cell)
    cells = {w["name"] for w in before["workloads"]}
    assert {w["config"] for w in before["workloads"]} <= {
        c["name"] for c in before["configs"]}
    for m in before["end_to_end"] + before["per_layer"]:
        if "workloads" in m:
            assert m["workloads"] and set(m["workloads"]) <= cells, m


def test_family_came_as_appended_entries():
    """The MinkUNet family is in BENCHMARK.json as entries alone, in any
    place of its lists (assert_came_as_entries), and its cell loads with
    its family on one chip."""
    assert_came_as_entries(BENCH, CONFIG, CELL, MINK_METRICS, "s_per_step")
    c = spec.load_cell(CELL)
    assert c.family().__name__.endswith("minkunet") and c.chips == 1


def test_a_family_appended_after_it_keeps_the_property(tmp_path):
    """A second family appended after MinkUNet (tiny.add_second_family,
    its cell in s_per_step's list too, as a training family's would be)
    leaves MinkUNet's property whole and has it itself; both cells load
    by name, and make_root maps the added cell by its window."""
    root = tiny.add_second_family(tiny.copy_repo_root(tmp_path / "repo"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        if m["name"] == "s_per_step":
            m["workloads"].append(tiny.SECOND_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert bench["workloads"][-1]["name"] == tiny.SECOND_CELL
    assert_came_as_entries(bench, CONFIG, CELL, MINK_METRICS, "s_per_step")
    assert_came_as_entries(bench, "tinyunet", tiny.SECOND_CELL, {"mfu.seg"},
                           "latency_p95_s")
    for name in (CELL, tiny.SECOND_CELL):
        assert spec.load_cell(name, root).family().LIMIT_NAMES
    made = json.loads((tiny.make_root(tmp_path / "tiny", root)
                       / "BENCHMARK.json").read_text())
    got = {m["name"]: m.get("workloads") for m in made["per_layer"]}
    assert got["mfu.seg"] == ["tiny.mixed", "tiny.single"]
    assert got["BN_roofline.seg_train"] == ["tiny.train", "tiny3g.train"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the repo's root with the family's configuration at an
    eighth of its widths in float32 and its mix (seg_train) of small
    buildings."""
    root = tiny.copy_repo_root(tmp_path_factory.mktemp("mink"))
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / f"{CONFIG}.json").read_text())
    m = cfg["model"]
    m.update(planes=[p // 8 for p in m["planes"]], init_dim=4,
             compute_dtype="float32",
             caps={"max_points": 8192, "voxel_caps": [8192] * 5,
                   "max_gt": 32})
    (pb / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    (pb / "traffic/seg_train.json").write_text(json.dumps(
        {"window": "labelled_train", "buildings": tiny.BUILDINGS,
         "checked_steps": 3, "profile_after": 1, "profile_steps": 2}))
    return root


def test_cell_runs_with_the_contract_keys(root):
    r = run.run_cell(tiny.args(CELL, seconds=1.0), require_card=False,
                     root=root)
    assert list(r) == KEYS
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["compared"]) == {"loss", "grad", "change", "change_q90"}
    assert set(r["metrics"]) == {"setup_s", "s_per_step"}


def test_window_labels_the_pool_before_the_train_window(root, monkeypatch):
    """labelled_train gives every building of the pool its points' box
    labels before the train window's first step, so the steps train on
    labels that pad_scene carries, and the model labels nothing."""
    from detection_3d_tpu_torch.engine import trainer
    from perfbench.traffic.box_labels import label_scene
    seen = []
    real = trainer.pad_scene

    def pad(cfg, scene):
        seen.append("point_labels" in scene)
        out = real(cfg, scene)
        assert "point_labels" in out
        return out
    monkeypatch.setattr(trainer, "pad_scene", pad)
    c = spec.load_cell(CELL, root)
    assert c.traffic["window"] == "labelled_train"
    r = run.prepare(c, 7, 0.1, False, torch.device("cpu"))
    assert not any("point_labels" in b for b in r.pool)
    run.drive(r)
    assert seen and all(seen)
    for b in r.pool:
        want = label_scene(b, "cpu")
        assert (b["point_labels"] == want).all()
        assert (want >= 0).any() and want.shape == (b["points"].shape[0],)


@pytest.mark.parametrize("fault", sorted(
    spec.family(spec.ROOT, "minkunet").FAULTS))
def test_planted_fault_is_not_correct(root, monkeypatch, fault):
    """Each fault planted in the program's step fails the cell's check
    under the repo's own limits."""
    fam = spec.load_cell(CELL, root).family()
    fam.FAULTS[fault](monkeypatch.setattr)
    r = run.run_cell(tiny.args(CELL, seconds=1.0), require_card=False,
                     root=root)
    assert r["correct"] is False, r["compared"]


def test_fp8_control_fails_the_check(root):
    """The reference in float8 (the family's control) put in the
    program's place fails the check under the repo's own limits."""
    c = spec.load_cell(CELL, root)
    r = run.prepare(c, 5, 0.1, False, torch.device("cpu"))
    run.drive(r)
    r.draws = run.close_window(r)["draws"]
    fam = r.family
    want = fam.reference_steps(r, run.reference_model(r), 3)
    got = fam.reference_steps(r, run.reference_model(r, fam.control), 3)
    numbers = train.numbers(got, want, r.weights)
    assert not compare.judge(numbers, c.limits())[0], numbers


def test_work_counts_the_stem_and_the_books(root):
    """building_work counts the stem as a 125-offset conv over the
    level-0 voxels, one stride-2 pair a finer voxel, and one B book a
    level plus the 5^3 one."""
    c = spec.load_cell(CELL, root)
    fam = c.family()
    ref_cfg = fam.reference_config(c.config)
    from perfbench.traffic.pool import make_pool
    b = make_pool(3, tiny.BUILDINGS, ref_cfg.classes, workers=1)[0]
    work = fam.building_work(ref_cfg, fam.reference_pad(ref_cfg, b), "cpu",
                             train=True)
    convs = {cv.name: cv for cv in work["a_convs"]}
    stem = work["a_convs"][0]
    assert stem.name == "stem" and stem.k == 125 and stem.cin == 3
    assert stem.pairs >= stem.rows_out > 0
    assert convs["down1"].pairs == convs["down1"].rows_in == stem.rows_in
    assert convs["up0"].pairs == convs["up0"].rows_out == stem.rows_in
    assert [bk["k"] for bk in work["b_books"]] == [27] * 5 + [125]
    assert work["b_books"][-1]["rows"] == stem.rows_in
    conv = sum(cv.flops for cv in work["a_convs"])
    assert 3 * conv < work["flops"] < 4.5 * conv   # and the dense products


def test_work_counts_a_bn_site_after_every_conv_and_projection(root):
    """building_work counts one BN site after each conv kernel A runs, on
    its output rows and channels, and one after each of the 7 1^3
    projections (blocks 2-8 change their width): 62 sites, each of 5
    passes in a training step and 2 in a forward."""
    c = spec.load_cell(CELL, root)
    fam = c.family()
    ref_cfg = fam.reference_config(c.config)
    from perfbench.traffic.pool import make_pool
    b = make_pool(3, tiny.BUILDINGS, ref_cfg.classes, workers=1)[0]
    padded = fam.reference_pad(ref_cfg, b)
    work = fam.building_work(ref_cfg, padded, "cpu", train=True)
    convs, sites = work["a_convs"], work["bn_sites"]
    assert len(sites) == len(convs) + 7 == 62
    assert [(s["rows"], s["c"]) for s in sites[:len(convs)]] == [
        (cv.rows_out, cv.cout) for cv in convs]
    assert {s["passes"] for s in sites} == {5}
    served = fam.building_work(ref_cfg, padded, "cpu")["bn_sites"]
    assert [dict(s, passes=5) for s in served] == sites
    assert {s["passes"] for s in served} == {2}


def test_b_roofline_reader():
    """Each book's least bytes (entries, mask words, key and coordinates
    of each row) over the bandwidth, over B's device time; None without
    books, a sub-window or B's time."""
    read = spec.metric_reader(spec.ROOT, "B_roofline.seg_train")
    books = [{"k": 27, "rows": 1000}, {"k": 125, "rows": 1000}]
    hbm = 1e12
    r = SimpleNamespace(
        sub={"kernel_s": {"B": 1e-6}}, peaks={"hbm": hbm},
        window={"sub_buildings": [0, 0]}, work=[{"b_books": books}])
    least = 2 * 1000 * ((4 * 27 + 8 + 24) + (4 * 125 + 16 + 24)) / hbm
    assert read(r) == pytest.approx(100.0 * least / 1e-6)
    r.work = [{}]
    assert read(r) is None
    r.work, r.sub = [{"b_books": books}], {"kernel_s": {"B": 0.0}}
    assert read(r) is None
    r.sub = None
    assert read(r) is None


def test_plan_share_reader():
    from detection_3d_tpu_torch.utils.profiling import SpanRecord
    read = spec.metric_reader(spec.ROOT, "plan_share.seg_train")
    ms = 1_000_000
    log = [SpanRecord("model.plan", 1, 0, 30 * ms, 1, None, None, 0, 0),
           SpanRecord("model.plan", 1, 100 * ms, 150 * ms, 2, None, None,
                      0, 0),
           SpanRecord("model.stem", 1, 150 * ms, 160 * ms, 3, None, None,
                      0, 0)]
    r = SimpleNamespace(sub={"window_s": 1.0}, spans=log)
    assert read(r) == pytest.approx(8.0)
    r.spans = log[2:]
    assert read(r) is None
