"""Scene-pack binary format: writer and pure-Python reader.

Counterpart of detection_3d_tpu/data/scene_pack.py, byte for byte: the
on-disk unit the C++ prefetching loader (native/scene_loader.cpp,
data/native_loader.py) streams, one building a file, seek-free so a C++
thread reads it without the interpreter lock.

Layout: magic ``SPK1`` | u32 n_arrays | per array:
  u32 name_len | name | u32 dtype_code | u32 ndim | u64 dims[ndim] |
  u64 byte_len | raw data (C order), all little-endian.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

MAGIC = b"SPK1"

DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint8): 4,
    np.dtype(np.bool_): 5,
}
CODE_DTYPES = {v: k for k, v in DTYPE_CODES.items()}


def write_scene_pack(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``arrays`` (name -> array of a dtype in DTYPE_CODES) to
    ``path``; raises ValueError on any other dtype."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(arrays)))
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            if arr.dtype not in DTYPE_CODES:
                raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<I", DTYPE_CODES[arr.dtype]))
            f.write(struct.pack("<I", arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<Q", d))
            raw = arr.tobytes()
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)


def read_scene_pack(path: str) -> Dict[str, np.ndarray]:
    """The arrays of one scene pack (the reference the C++ loader is held
    against); raises ValueError when the file is not a scene pack."""
    out = {}
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"not a scene pack: {path}")
        (n,) = struct.unpack("<I", f.read(4))
        for _ in range(n):
            (nl,) = struct.unpack("<I", f.read(4))
            name = f.read(nl).decode()
            (code,) = struct.unpack("<I", f.read(4))
            (ndim,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim)) if ndim \
                else ()
            (blen,) = struct.unpack("<Q", f.read(8))
            data = f.read(blen)
            out[name] = np.frombuffer(
                data, dtype=CODE_DTYPES[code]).reshape(dims).copy()
    return out
