"""The port's scene-pack format (data/scene_pack.py) and its converter
tool against the JAX package's: the same dict gives the same bytes,
each package reads the other's files, every dtype code round-trips, a
file without the magic and an unsupported dtype raise, and
``convert_scene_packs --synthetic 2`` writes the JAX tool's files byte
for byte.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from detection_3d_tpu.data import scene_pack as jpack
from detection_3d_tpu_torch.data import scene_pack as tpack

ROOT = Path(__file__).resolve().parent.parent

DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_]


def _scene(seed):
    """A dict with every dtype code, a scalar and an empty array."""
    rng = np.random.RandomState(seed)
    return {
        "points": rng.randn(37, 3).astype(np.float32),
        "feats": rng.randn(37, 9).astype(np.float64),
        "gt_labels": rng.randint(0, 5, 4).astype(np.int32),
        "ids": rng.randint(-2 ** 40, 2 ** 40, (2, 3, 2)).astype(np.int64),
        "rgb_q": rng.randint(0, 256, (5, 3)).astype(np.uint8),
        "valid": rng.rand(6) > 0.5,
        "scene_id": np.int64(seed),
        "empty": np.zeros((0, 7), np.float32),
    }


def test_codes_match_jax():
    assert tpack.MAGIC == jpack.MAGIC
    assert tpack.DTYPE_CODES == jpack._DTYPES
    assert tpack.CODE_DTYPES == jpack._CODES


@pytest.mark.parametrize("seed", [0, 1])
def test_files_are_byte_equal_and_cross_read(tmp_path, seed):
    scene = _scene(seed)
    mine, theirs = tmp_path / "port.spk", tmp_path / "jax.spk"
    tpack.write_scene_pack(str(mine), scene)
    jpack.write_scene_pack(str(theirs), scene)
    assert mine.read_bytes() == theirs.read_bytes()
    for got in (tpack.read_scene_pack(str(theirs)),
                jpack.read_scene_pack(str(mine))):
        assert list(got) == list(scene)
        for k, v in scene.items():
            v = np.ascontiguousarray(v)    # a 0-d array is written (1,)
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_code_round_trips(tmp_path, dtype):
    a = (np.arange(24).reshape(2, 3, 4) % 7).astype(dtype)
    path = str(tmp_path / "one.spk")
    tpack.write_scene_pack(path, {"a": a, "b": a[:, ::2]})   # non-contig.
    got = tpack.read_scene_pack(path)
    assert got["a"].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got["a"], a)
    np.testing.assert_array_equal(got["b"], a[:, ::2])
    code = int.from_bytes(Path(path).read_bytes()[13:17], "little")
    assert tpack.CODE_DTYPES[code] == np.dtype(dtype)


def test_bad_magic_and_unsupported_dtype_raise(tmp_path):
    path = tmp_path / "bad.spk"
    path.write_bytes(b"SPK0" + bytes(12))
    with pytest.raises(ValueError, match="not a scene pack"):
        tpack.read_scene_pack(str(path))
    with pytest.raises(ValueError, match="unsupported dtype"):
        tpack.write_scene_pack(str(tmp_path / "x.spk"),
                               {"a": np.zeros(3, np.int16)})


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def test_converter_writes_the_jax_tools_files(tmp_path):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    out = _run(["-m", "detection_3d_tpu_torch.tools.convert_scene_packs",
                "--out", str(mine), "--synthetic", "2"])
    assert "wrote 2 scene packs" in out
    _run(["tools/convert_scene_packs.py", "--out", str(theirs),
          "--synthetic", "2"])
    names = sorted(os.listdir(theirs))
    assert names == sorted(os.listdir(mine)) == ["syn_00000.spk",
                                                 "syn_00001.spk"]
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
    scene = tpack.read_scene_pack(str(mine / names[1]))
    assert set(scene) == {"points", "feats", "gt_boxes", "gt_labels"}
