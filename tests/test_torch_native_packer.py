"""The port's C++ pyramid packer (native/pyramid_packer.cpp, built with
g++ here) against its numpy packers: byte for byte, for the pyramid
(on 1 and 4 threads) and the table, with and without the capacity-
overflow keep at scale 0. A source that does not build raises, with the
compiler's output, instead of falling back to numpy.
"""

import dataclasses

import numpy as np
import pytest

from detection_3d_tpu_torch.data import native_packer
from detection_3d_tpu_torch.data.packing import pack_table
from detection_3d_tpu_torch.data.pyramid_packing import pack_pyramid
from test_torch_common import cfg_pair, tiny_scene

CAPS0 = {"fits": 8192, "overflow": 4096, "overflow6": 1024}


def _cfg(case):
    _, tc = cfg_pair()
    return dataclasses.replace(tc, caps=dataclasses.replace(
        tc.caps, voxel_caps=(CAPS0[case],) + tc.caps.voxel_caps[1:]))


def _assert_same_bytes(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("case", sorted(CAPS0))
def test_native_pyramid_matches_numpy(case, n_threads):
    cfg = _cfg(case)
    scene = tiny_scene(11)
    want = pack_pyramid(cfg, scene)
    _assert_same_bytes(
        native_packer.pack_pyramid_native(cfg, scene, n_threads=n_threads),
        want)
    assert (int(want["true_num"]) > CAPS0[case]) == (case != "fits")


@pytest.mark.parametrize("case", sorted(CAPS0))
def test_native_table_matches_numpy(case):
    cfg = _cfg(case)
    scene = tiny_scene(12)
    _assert_same_bytes(native_packer.pack_table_native(cfg, scene),
                       pack_table(cfg, scene))


@pytest.mark.parametrize("broken", ["missing", "syntax"])
def test_broken_source_raises(tmp_path, monkeypatch, broken):
    """A source that is missing, or that g++ refuses (its output in the
    message), makes both pack entry points raise: no numpy fallback."""
    src = tmp_path / "pyramid_packer.cpp"
    if broken == "syntax":
        src.write_text("int pp_create( {\n")
    monkeypatch.setattr(native_packer, "SOURCE", src)
    _, cfg = cfg_pair()
    want = {"missing": "unreadable",
            "syntax": "(?s)g\\+\\+ failed.*error"}[broken]
    for pack in (native_packer.pack_pyramid_native,
                 native_packer.pack_table_native):
        with pytest.raises(RuntimeError, match=want):
            pack(cfg, tiny_scene(0))
