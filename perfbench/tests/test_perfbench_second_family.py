"""A model of another family than the detector, added to a checkout root
as files and entries alone (tiny.add_second_family): its family file,
its configuration, a traffic mix with its window file, and limits. It
runs through harness.run_cell with the contract's keys, its check fails
a fault planted in the program's answer and the float8 control, and the
addition leaves every file the root held before it as it was."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from perfbench import compare, harness as run, spec
from perfbench.tests import tiny

torch.set_num_threads(2)
CELL = tiny.SECOND_CELL
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def _digests(root: Path):
    """sha256 of every file under ``root``, by its relative path."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """(root with the family added, its files' digests and its
    BENCHMARK.json before the addition)."""
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    tiny.add_second_family(root)
    return root, before, bench


@pytest.mark.parametrize("trace", [0, 1])
def test_second_family_runs_with_the_contract_keys(added, trace):
    root = added[0]
    r = run.run_cell(tiny.args(CELL, trace=trace, seconds=1.0),
                     require_card=False, root=root)
    assert list(r) == KEYS
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["compared"]) == {"logit_gap"}
    # no peaks for the CPU: mfu.seg finds nothing to read there
    assert set(r["metrics"]) == (set() if trace else
                                 {"setup_s", "latency_p95_s"})


def _scaled(out):
    """An answer altered where it is produced: the UNet's features 1 %
    larger."""
    return out * 1.01


def _half_rows(out):
    """Half of the voxels left out: their features zero."""
    out = out.clone()
    out[out.shape[0] // 2:] = 0.0
    return out


@pytest.mark.parametrize("fault", [_scaled, _half_rows])
def test_second_family_fails_a_planted_fault(added, monkeypatch, fault):
    from detection_3d_tpu_torch.models.factories import SparseUNet
    real = SparseUNet.forward
    monkeypatch.setattr(SparseUNet, "forward",
                        lambda self, *a, **k: fault(real(self, *a, **k)))
    r = run.run_cell(tiny.args(CELL, seconds=1.0), require_card=False,
                     root=added[0])
    assert r["correct"] is False and r["failed"] > 0


def test_second_family_control_is_not_correct(added):
    """The twin in float8 (the family's control) put in the program's
    place fails the check."""
    cell = spec.load_cell(CELL, added[0])
    r = run.prepare(cell, 5, 0.1, False, torch.device("cpu"))
    ref = run.reference_model(r)
    ctl = run.reference_model(r, r.family.control)
    answers = [(b, r.family.reference_answer(r, ctl, b))
               for b in range(len(r.pool))]
    numbers = compare.worst(run.check(r, answers, ref))
    assert not compare.judge(numbers, cell.limits())[0], numbers


def test_adding_the_family_took_files_alone(added):
    """The cell loads by name with its family and its limits are the
    family's numbers; every file the root held before the family came
    has the same bytes, and BENCHMARK.json only gained entries and the
    new cell in its end-to-end metric's list."""
    root, before, bench = added
    cell = spec.load_cell(CELL, root)
    assert set(cell.limits()) <= cell.family().LIMIT_NAMES
    after = _digests(root)
    del before["BENCHMARK.json"]
    assert {k: after.get(k) for k in before} == before
    assert len(after) > len(before) + 1
    new = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        assert new[key][:len(bench[key])] == bench[key]
        assert len(new[key]) == len(bench[key]) + 1
    assert [dict(m, **({"workloads": [w for w in m["workloads"]
                                      if w != CELL]}
                       if "workloads" in m else {}))
            for m in new["end_to_end"]] == bench["end_to_end"]
