"""Build and load the port's host C++ libraries (native/*.cpp).

Each source compiles with g++ at first use into
``detection_3d_tpu_torch/build/`` under a name that carries a digest of
the source and flags, under a file lock, so concurrent processes build
it once and an edited source is never served by a stale library. A
failed build or load raises with the compiler's output: the callers
have no Python fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def load(source: Path, stem: str,
         declare: Callable[[ctypes.CDLL], ctypes.CDLL]) -> ctypes.CDLL:
    """The library built from ``source`` as ``build/{stem}-{digest}.so``,
    its symbols typed by ``declare``; compiled on first use. Raises
    RuntimeError when the source is unreadable or g++ is missing or
    fails (with its output), and OSError when the library does not
    load."""
    source = Path(source).resolve()
    with _lock:
        if source in _libs:
            return _libs[source]
        try:
            text = source.read_bytes()
        except OSError as e:
            raise RuntimeError(f"{stem} source unreadable: {e}") from e
        digest = hashlib.sha1(text + " ".join(FLAGS).encode()).hexdigest()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{stem}-{digest[:12]}.so"
        with open(BUILD_DIR / f"{stem}.lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if not so.exists():
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                try:
                    res = subprocess.run(
                        ["g++", *FLAGS, str(source), "-o", str(tmp)],
                        capture_output=True, text=True, timeout=300)
                except (OSError, subprocess.TimeoutExpired) as e:
                    raise RuntimeError(
                        f"g++ could not build {stem}: {e}") from e
                if res.returncode != 0:
                    raise RuntimeError(
                        f"g++ failed to build {source} ({res.returncode}):"
                        f"\n{res.stdout}{res.stderr}")
                os.replace(tmp, so)
        _libs[source] = declare(ctypes.CDLL(str(so)))
        return _libs[source]
