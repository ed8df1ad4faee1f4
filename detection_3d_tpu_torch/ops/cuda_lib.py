"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``detection_3d_tpu_torch/csrc/`` has a plain C
interface and compiles on its own with ``nvcc`` into a shared library
that is loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). Libraries go to ``detection_3d_tpu_torch/build/`` under a name
that carries a digest of the source and flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is built or loaded
at import time: :func:`library` builds on first use, and
:func:`build` compiles several sources at once (one ``nvcc`` process
each, all started together).

``launches`` counts, per kernel, the launches its wrapper made: the
forward and dFeats entries of csrc/gather_conv.cu count apart, and dW
(csrc/gather_conv_bwd.cu) and the greedy NMS pass (csrc/greedy_nms.cu,
a pack and a walk) count once per call, and so do the masked BN's four
(csrc/masked_bn.cu: statistics and the backward's sums, each a pass and
its fold; normalise; dx). A wrapper adds one exactly where it launches its kernel; a
run can then show that a path went through every kernel. A launch made
while a CUDA graph captures counts like any other; a replay of that
graph calls no wrapper and counts nothing (engine/inference's
``GraphedForward.replays`` counts the replays).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# one library per source file under csrc/
KERNELS = ("gather_conv", "gather_conv_bwd", "subm_match", "rotated_iou",
           "multi_match", "greedy_nms", "masked_bn")
# one launch counter per kernel: kernel A's source runs the forward and
# the backward's dFeats, the backward source dW
COUNTERS = ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
            "subm_match", "rotated_iou", "multi_match", "greedy_nms",
            "masked_bn_stats", "masked_bn_normalise", "masked_bn_dsums",
            "masked_bn_dx")
# each counter's kernel symbols in a device trace (kernel A's body runs
# under the ConvForward and ConvDFeats tags; dW is a partial kernel and
# its reduction, D one of three forms, E a pack and a walk, BN's sums a
# pass and a fold), and the kernel's short name in the tools' reports
SYMBOLS = {"gather_conv": "ConvForward", "gather_conv_dfeats": "ConvDFeats",
           "gather_conv_dw": "gather_dw_", "subm_match": "subm_match_",
           "rotated_iou": "rotated_iou_kernel",
           "multi_match": "multi_match_",
           "greedy_nms": "greedy_nms_",
           "masked_bn_stats": "masked_bn_stats_",
           "masked_bn_normalise": "masked_bn_normalise",
           "masked_bn_dsums": "masked_bn_dsums_",
           "masked_bn_dx": "masked_bn_dx"}
LABELS = {"gather_conv": "A", "gather_conv_dfeats": "dFeats",
          "gather_conv_dw": "dW", "subm_match": "B", "rotated_iou": "C",
          "multi_match": "D", "greedy_nms": "E",
          "masked_bn_stats": "BN stats", "masked_bn_normalise": "BN",
          "masked_bn_dsums": "BN' sums", "masked_bn_dx": "BN' dx"}
# the dynamic shared memory one block may take on an H100 (227 KB):
# kernel B's wrapper keeps its windows under it
SHARED_BYTES = 232448
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# the IoU kernel's strict orientation tests must round like the plain
# version: no contracted multiply-adds (csrc/rotated_iou.cu)
_EXTRA_FLAGS = {"rotated_iou": ["--fmad=false"]}

# the C entry points of each library: name -> argument types (pointers
# and the stream as c_void_p, sizes as c_int, a threshold as c_float);
# every one returns an int (the cudaError_t of its launch, or a size),
# those in _RESTYPES a wider one
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRY_POINTS = {
    "gather_conv": {name: [_P] * 6 + [_I] * 4 + [_P]
                    for role in ("gather_conv", "gather_conv_dfeats")
                    for tag in ("f32", "bf16")
                    for name in (f"{role}_{tag}", f"{role}_{tag}_w2")},
    "gather_conv_bwd": {"gather_conv_dw_f32": [_P] * 6 + [_I] * 5 + [_P],
                        "gather_conv_dw_bf16": [_P] * 6 + [_I] * 5 + [_P]},
    "subm_match": {"subm_match_3x3x3": [_P] * 3 + [_I] * 6 + [_P] * 3,
                   "subm_match_5x5x5": [_P] * 3 + [_I] * 5 + [_P] * 3},
    "rotated_iou": {"rotated_iou_matrix": [_P] * 2 + [_I] * 5 + [_P] * 2},
    "multi_match": {"multi_match": [_P] * 3 + [_I] * 3 + [_P]},
    "greedy_nms": {"greedy_nms": [_P] * 2 + [_F] + [_I] * 3 + [_P] * 4,
                   "greedy_nms_scratch_words": [_I]},
    "masked_bn": {name: args for tag in ("f32", "bf16") for name, args in (
        (f"masked_bn_stats_{tag}", [_P] * 4 + [_I] * 6 + [_P]),
        (f"masked_bn_normalise_{tag}", [_P] * 6 + [_I] * 4 + [_F] * 2
         + [_P]),
        (f"masked_bn_dsums_{tag}", [_P] * 9 + [_I] * 6 + [_F] * 2 + [_P]),
        (f"masked_bn_dx_{tag}", [_P] * 8 + [_I] * 4 + [_F] * 2 + [_P]))},
}

_RESTYPES = {"greedy_nms_scratch_words": ctypes.c_longlong}

launches: Dict[str, int] = {name: 0 for name in COUNTERS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str):
    return _FLAGS + _EXTRA_FLAGS.get(name, [])


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, in parallel.

    Returns {name: seconds} for the sources compiled by this call. Raises
    RuntimeError with the compiler's output when a build fails. The
    compiler's resource report (registers, shared memory, spills) is
    kept beside each library as ``<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    seconds, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          + log.decode(errors="replace"))
            continue
        out.with_suffix(".log").write_bytes(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn_name, argtypes in _ENTRY_POINTS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(fn_name, ctypes.c_int)
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(name: str, status: int) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if status != 0:
        msg = getattr(library(name), f"{name}_error_string")(status)
        raise RuntimeError(f"{name}: CUDA error {status}: "
                           f"{msg.decode(errors='replace')}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as a pointer for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream
