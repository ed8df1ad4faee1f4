"""The benchmark's description, read by name: ``BENCHMARK.json`` at the
root of the checkout and, under ``perfbench/`` there, one file a
configuration (``configs/``, named in BENCHMARK.json), one file a
traffic mix (``traffic/<name>.json``), one file a kind of window that
traffic mixes name (``windows/<window>.py``), one file of limits a cell
(``limits/<cell>.json``) and one reader a per-layer metric
(``metrics/<name>.py``, or ``metrics/<stem>.py`` shared by every metric
``<stem>.<part>``) and one file a model family (``families/<family>.py``,
named by a configuration's ``family``). A cell is an entry of
``workloads`` that names a configuration and a traffic mix; adding one,
or a model of another family, takes files and entries and no edit of
this code.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import typing
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""
    name: str
    chips: int
    config: Dict[str, Any]        # the configuration's file
    traffic: Dict[str, Any]       # the traffic mix's file
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    run_seconds: int
    root: Path                    # the checkout the files were read from

    def family(self):
        """The family module its configuration names (:func:`family`)."""
        return family(self.root, self.config["family"])

    def limits(self) -> Dict[str, float]:
        """The limits of the numbers the cell's check compares
        (``limits/<cell>.json``)."""
        return json.loads((self.root / "perfbench" / "limits"
                           / f"{self.name}.json").read_text())["limits"]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its configuration
    and traffic files and the metrics it reports. Raises FileNotFoundError
    or KeyError when something it names is missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                run_seconds=int(bench["run_seconds"]), root=root)


def _module(path: Path, prefix: str):
    """The Python file ``path`` loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str) -> Callable:
    """The ``read(run)`` function of ``perfbench/metrics/<name>.py`` under
    ``root``, else of ``metrics/<stem>.py`` for a name ``<stem>.<part>``:
    it returns the metric's value from what a traced run recorded, or
    None when it finds nothing to read."""
    metrics = root / "perfbench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.is_file():
        path = metrics / f"{name.split('.')[0]}.py"
    return _module(path, "perfbench_metric").read


def window(root: Path, name: str) -> Callable:
    """The ``window(run)`` function of ``perfbench/windows/<name>.py``
    under ``root``: it drives the program through a traffic mix's window
    (windows/stream.py says what it returns)."""
    return _module(root / "perfbench" / "windows" / f"{name}.py",
                   "perfbench_window").window


def family(root: Path, name: str):
    """``perfbench/families/<name>.py`` under ``root``, loaded as a module
    of its own: the model family's plug-in (families/sparse_rcnn.py states
    what one gives). run.py loads none: it starts the pool's workers
    before torch loads, and takes the pool's classes from the
    configuration's file, the ``classes`` of its ``model``."""
    return _module(root / "perfbench" / "families" / f"{name}.py",
                   "perfbench_family")


def _build(cls, values: Dict[str, Any]):
    """A frozen config dataclass ``cls`` from a JSON object: nested
    objects become their field's dataclass, lists become tuples."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            kw[f.name] = _build(t, v)
        else:
            kw[f.name] = _tuples(v)
    unknown = set(values) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise KeyError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
    return cls(**kw)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def build_config(config_cls, config_file: Dict[str, Any],
                 override: Optional[Dict[str, Any]] = None):
    """The ``Config`` of ``config_cls``'s package (the program's or the
    reference's: they share the layout) from a configuration file's
    ``model`` object, with ``override``'s top-level keys replaced."""
    values = dict(config_file["model"], **(override or {}))
    return _build(config_cls, values).validate()
