"""The import guard: the benchmark measures the PyTorch port and never
JAX or the JAX package, and its yardstick (the reference and the
traffic) takes nothing from the port. Modules are compared by their
top-level name, the part before the first dot, as a whole: the port's
name ``detection_3d_tpu_torch`` begins with the JAX package's name
``detection_3d_tpu`` and is not it."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "detection_3d_tpu")
PORT = "detection_3d_tpu_torch"
HERE = Path(__file__).resolve().parent


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is one of
    :data:`FORBIDDEN`."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def imports_of(path: Path) -> List[str]:
    """Every module a Python source imports, by its full name."""
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.append(node.module)
    return out


def port_imports_in(folders=("reference", "traffic")) -> List[str]:
    """``file: module`` for each import of the port (or of anything
    forbidden) by the sources of the yardstick's ``folders``."""
    bad = []
    for folder in folders:
        for path in sorted((HERE / folder).glob("*.py")):
            for mod in imports_of(path):
                if top_level(mod) in FORBIDDEN + (PORT,):
                    bad.append(f"{path.relative_to(HERE)}: {mod}")
    return bad
