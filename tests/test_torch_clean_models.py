"""The port's twin of tools/clean_models.py
(detection_3d_tpu_torch/tools/clean_models.py) on a tree of
``model_*.pt`` checkpoints against the JAX tool on the same tree with
``.msgpack`` files: the same basenames are removed and kept (the tagged
last checkpoint, model_final and model_min_loss stay; ``--keep-last 2``
spares the two newest snapshots too), ``log.txt`` is copied to
``_log.txt``, a glob names the run directories, and a path that is not a
directory is skipped with a warning."""

import importlib.util
import logging
import sys
from pathlib import Path

import pytest

from detection_3d_tpu_torch.tools import clean_models

ROOT = Path(__file__).resolve().parent.parent
RUNS = {"run_a": {"snaps": (100, 200, 300), "extra": ("final", "min_loss"),
                  "tag": "model_0000200", "log": "step 300 loss 1.0\n"},
        "run_b": {"snaps": (50, 150, 250, 350, 450), "extra": ("final",),
                  "tag": "model_final", "log": None}}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_clean_models", ROOT / "tools" / "clean_models.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root: Path, ext: str) -> Path:
    for run, spec in RUNS.items():
        d = root / run
        d.mkdir(parents=True)
        names = [f"model_{s:07d}" for s in spec["snaps"]] + \
            [f"model_{e}" for e in spec["extra"]]
        for name in names:
            (d / f"{name}{ext}").write_bytes(b"weights")
        (d / "last_checkpoint").write_text(spec["tag"] + ext)
        if spec["log"]:
            (d / "log.txt").write_text(spec["log"])
    (root / "not_a_dir.txt").write_text("x")
    return root


def _left(root: Path):
    return {run: sorted(p.stem if p.suffix in (".pt", ".msgpack") else p.name
                        for p in (root / run).iterdir())
            for run in RUNS}


@pytest.mark.parametrize("keep_last", [0, 2])
def test_prunes_what_the_jax_tool_prunes(tmp_path, monkeypatch, caplog,
                                         keep_last):
    jroot = _tree(tmp_path / "jax", ".msgpack")
    troot = _tree(tmp_path / "port", ".pt")
    opts = ["--keep-last", str(keep_last)] if keep_last else []
    monkeypatch.setattr(sys, "argv", ["clean_models.py", str(jroot / "run_*"),
                                      str(jroot / "not_a_dir.txt"), *opts])
    assert _jax_tool().main() == 0
    with caplog.at_level(logging.WARNING):
        assert clean_models.main([str(troot / "run_*"),
                                  str(troot / "not_a_dir.txt"), *opts]) == 0
    assert f"skipping {troot / 'not_a_dir.txt'}: not a directory" in \
        caplog.text
    assert (troot / "not_a_dir.txt").exists()
    left = _left(troot)
    assert left == _left(jroot)
    # what stays: the tag, final, min_loss and the keep_last newest of
    # the other snapshots
    for run, spec in RUNS.items():
        snaps = [f"model_{s:07d}" for s in spec["snaps"]
                 if f"model_{s:07d}" != spec["tag"]]
        kept = {spec["tag"], *(f"model_{e}" for e in spec["extra"]),
                *(snaps[-keep_last:] if keep_last else ())}
        assert {n for n in left[run] if n.startswith("model_")} == kept
    assert (troot / "run_a" / "_log.txt").read_text() == \
        RUNS["run_a"]["log"]
    assert not (troot / "run_b" / "_log.txt").exists()
