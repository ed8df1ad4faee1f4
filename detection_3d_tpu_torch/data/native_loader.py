"""ctypes wrapper of the C++ prefetching scene loader
(native/scene_loader.cpp).

Counterpart of detection_3d_tpu/data/native_loader.py: scene packs
(data/scene_pack.py) are read and decoded on a C++ thread pool ahead of
the training step, so the host's file IO overlaps the card's work.
:class:`NativeSceneLoader` is a source for ``Trainer.train``: it has
``__len__`` and ``epoch(order)``, which yields one scene dict per index.

The library is built with g++ at first use (data/native_build.py). A
failed build or load raises with the compiler's output, and a file that
cannot be opened or is not a scene pack raises IOError with the C++
side's message when the epoch reaches it: there is no Python fallback,
unlike the JAX package's loader.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence

import numpy as np

from detection_3d_tpu_torch.data import native_build
from detection_3d_tpu_torch.data.scene_pack import CODE_DTYPES

SOURCE = native_build.PKG / "native" / "scene_loader.cpp"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sl_open.restype = p
    lib.sl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, i, i]
    lib.sl_set_order.restype = None
    lib.sl_set_order.argtypes = [p, ctypes.POINTER(i), i]
    lib.sl_next.restype = p
    lib.sl_next.argtypes = [p]
    for fn in (lib.sl_scene_ok, lib.sl_scene_n_arrays):
        fn.restype = i
        fn.argtypes = [p]
    lib.sl_scene_error.restype = ctypes.c_char_p
    lib.sl_scene_error.argtypes = [p]
    lib.sl_scene_name.restype = ctypes.c_char_p
    for fn in (lib.sl_scene_name, lib.sl_scene_dtype, lib.sl_scene_ndim,
               lib.sl_scene_dims, lib.sl_scene_data,
               lib.sl_scene_byte_len):
        fn.argtypes = [p, i]
    lib.sl_scene_dtype.restype = i
    lib.sl_scene_ndim.restype = i
    lib.sl_scene_dims.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.sl_scene_data.restype = p
    lib.sl_scene_byte_len.restype = ctypes.c_uint64
    for fn in (lib.sl_release, lib.sl_close):
        fn.restype = None
        fn.argtypes = [p]
    return lib


def library() -> ctypes.CDLL:
    """The loaded scene-loader library built from :data:`SOURCE`
    (data/native_build.load: raises when it cannot be built or loaded)."""
    return native_build.load(SOURCE, "libsceneloader", _declare)


class NativeSceneLoader:
    """Epoch iterator over scene packs with C++ thread-pool prefetch::

        loader = NativeSceneLoader(paths, n_prefetch=4, n_threads=2)
        for scene in loader.epoch(order):   # dict[str, np.ndarray]
            ...
        loader.close()

    ``n_prefetch`` scenes ahead of the one yielded are read on
    ``n_threads`` threads. An order may repeat indices; a new epoch drops
    what the last one had prefetched."""

    def __init__(self, paths: Sequence[str], n_prefetch: int = 4,
                 n_threads: int = 2):
        self.paths = [os.fspath(p) for p in paths]
        self._lib = library()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._h = self._lib.sl_open(arr, len(self.paths), n_prefetch,
                                    n_threads)

    def __len__(self):
        return len(self.paths)

    @property
    def is_native(self) -> bool:
        """True while the C++ loader is open (there is no other reader)."""
        return self._h is not None

    def epoch(self, order: Optional[Sequence[int]] = None):
        """Yield the scene of each index of ``order`` (default: every path
        in turn) in that order. Raises IndexError for an index outside
        the paths and IOError for a file the C++ side cannot read."""
        if self._h is None:
            raise RuntimeError("NativeSceneLoader is closed")
        idx = [int(i) for i in (range(len(self.paths)) if order is None
                                else order)]
        bad = [i for i in idx if not 0 <= i < len(self.paths)]
        if bad:
            raise IndexError(f"scene indices {bad} outside 0.."
                             f"{len(self.paths) - 1}")
        lib = self._lib
        lib.sl_set_order(self._h, (ctypes.c_int * len(idx))(*idx), len(idx))
        for _ in idx:
            sc = lib.sl_next(self._h)
            if not sc:
                raise RuntimeError("scene loader exhausted early")
            try:
                if not lib.sl_scene_ok(sc):
                    raise IOError(lib.sl_scene_error(sc).decode())
                yield _scene(lib, sc)
            finally:
                lib.sl_release(sc)

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.sl_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _scene(lib, sc) -> Dict[str, np.ndarray]:
    """Copy one loaded scene's arrays out of the C++ buffers."""
    out: Dict[str, np.ndarray] = {}
    for i in range(lib.sl_scene_n_arrays(sc)):
        code = lib.sl_scene_dtype(sc, i)
        if code not in CODE_DTYPES:
            raise IOError(f"scene pack array {i}: unknown dtype code {code}")
        dims = lib.sl_scene_dims(sc, i)
        shape = tuple(dims[j] for j in range(lib.sl_scene_ndim(sc, i)))
        nbytes = lib.sl_scene_byte_len(sc, i)
        buf = (ctypes.c_char * nbytes).from_address(lib.sl_scene_data(sc, i)) \
            if nbytes else b""
        out[lib.sl_scene_name(sc, i).decode()] = np.frombuffer(
            buf, dtype=CODE_DTYPES[code]).reshape(shape).copy()
    return out
