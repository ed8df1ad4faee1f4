"""ctypes wrapper of the native pyramid packer (native/pyramid_packer.cpp).

Counterpart of detection_3d_tpu/data/native_packer.py.
:func:`pack_pyramid_native` gives :func:`data.pyramid_packing.
pack_pyramid`'s dict and :func:`pack_table_native`
:func:`data.packing.pack_table`'s, byte for byte
(tests/test_torch_native_packer.py): the input layer's dedup, every
downsample table and every conv, deconv, submanifold and BEV rulebook
with its row order, and with ``backward`` the backward books' entry
lists and BEV transposes, built in C++ (the submanifold searches on
``n_threads`` threads). The call releases the interpreter lock while
the C++ runs; the padding and the median origin before it are numpy.

The library is compiled with g++ at first use (data/native_build.py).
A failed build or load raises with the compiler's output: there is no
numpy fallback, so no timing is ever taken on the numpy packer by
accident.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from detection_3d_tpu_torch.data import native_build
from detection_3d_tpu_torch.data.packing import pad_scene
from detection_3d_tpu_torch.data.pyramid_packing import pyramid_pack_spec

SOURCE = native_build.PKG / "native" / "pyramid_packer.cpp"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pp_create.restype = p
    lib.pp_create.argtypes = [i, i, i, i, p, p, p, p, i, i, i]
    lib.pp_set_out.restype = None
    lib.pp_set_out.argtypes = [p, ctypes.c_char_p, p, ctypes.c_int64]
    for run in (lib.pp_run, lib.pp_run_table):
        run.restype = i
        run.argtypes = [p, p, p, ctypes.c_int64]
    lib.pp_last_error.restype = ctypes.c_char_p
    lib.pp_last_error.argtypes = [p]
    lib.pp_destroy.restype = None
    lib.pp_destroy.argtypes = [p]
    return lib


def library() -> ctypes.CDLL:
    """The loaded packer library built from :data:`SOURCE`
    (data/native_build.load: raises when it cannot be built or
    loaded)."""
    return native_build.load(SOURCE, "libpyramidpacker", _declare)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _run(cfg, scene: Dict, n_threads: int, table_only: bool,
         backward: bool = False) -> Dict[str, np.ndarray]:
    lib = library()
    if cfg.in_channels != 9:
        raise ValueError("pack supports the 9-channel layout only")
    s3d = cfg.sparse3d
    X, Y, Z = s3d.voxel_full_scale
    n_scales = s3d.num_scales
    caps = cfg.caps.scale_caps(n_scales)
    if max(X, Y, Z) >= 1 << 16 or caps[0] >= 1 << 32:
        raise ValueError("grid too large for u16 table packing")

    batch = pad_scene(cfg, scene)
    m = int(batch["points_valid"].sum())
    pts = np.ascontiguousarray(batch["points"][:m], np.float32)
    feats = np.ascontiguousarray(batch["feats"][:m, :9], np.float32)
    scale = float(s3d.voxel_scale)
    res0 = feats[:, :3] - pts / scale
    origin = (np.median(res0, axis=0).astype(np.float32)
              if m else np.zeros(3, np.float32))

    out: Dict[str, np.ndarray] = {
        "vox": np.empty((caps[0], 3), np.uint16),
        "res_q": np.empty((caps[0], 3), np.uint8),
        "rgb_q": np.empty((caps[0], 3), np.uint8),
        "nrm_q": np.empty((caps[0], 3), np.int8),
        "num": np.empty((), np.int32),
        "true_num": np.empty((), np.int32),
    }
    if not table_only:
        # an _entries buffer holds its book's most entries; only the pages
        # the packer writes are touched
        for name, (shape, dt) in pyramid_pack_spec(cfg, backward).items():
            out[name] = np.empty(shape, dt)

    caps_a = np.asarray(caps, np.int64)
    kern = np.asarray(s3d.kernels[:n_scales - 1], np.int32).reshape(-1)
    strd = np.asarray(s3d.strides[:n_scales - 1], np.int32).reshape(-1)
    bev = np.asarray([n_scales - 1 - i for i in cfg.rpn.rpn_scales_from_top],
                     np.int32)
    h = lib.pp_create(X, Y, Z, n_scales, _ptr(caps_a), _ptr(kern),
                      _ptr(strd), _ptr(bev), len(bev), n_threads,
                      int(backward))
    try:
        for name, arr in out.items():
            lib.pp_set_out(h, name.encode(), _ptr(arr), arr.nbytes)
        runner = lib.pp_run_table if table_only else lib.pp_run
        rc = runner(h, _ptr(pts), _ptr(feats), m)
        if rc != 0:
            raise RuntimeError(
                f"pyramid packer rc={rc}: "
                f"{lib.pp_last_error(h).decode('utf-8', 'replace')}")
    finally:
        lib.pp_destroy(h)

    for name, arr in out.items():     # the counts, as the numpy packers
        if arr.ndim == 0:
            out[name] = np.int32(arr)
        elif name.endswith("_entries"):   # the entries written, own memory
            out[name] = arr[:out[name[:-len("entries")] + "starts"][-1]
                            ].copy()
    out["origin"] = origin
    out["gt_boxes"] = batch["gt_boxes"]
    out["gt_labels"] = batch["gt_labels"]
    out["gt_valid"] = batch["gt_valid"]
    return out


def pack_pyramid_native(cfg, scene: Dict, n_threads: int = 8,
                        backward: bool = False) -> Dict[str, np.ndarray]:
    """C++ :func:`data.pyramid_packing.pack_pyramid` (``backward`` as
    there)."""
    return _run(cfg, scene, n_threads, False, backward)


def pack_table_native(cfg, scene: Dict,
                      n_threads: int = 1) -> Dict[str, np.ndarray]:
    """C++ :func:`data.packing.pack_table`: the input layer only (sort,
    dedup-average, quantize), the table serving mode's whole host cost
    per building."""
    return _run(cfg, scene, n_threads, True)
