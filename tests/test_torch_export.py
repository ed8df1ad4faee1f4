"""The port's prediction export (detection_3d_tpu_torch/data/export.py)
against the JAX package's predictions_to_txt: the same per-room text
files, byte for byte (yx_zb boxes turned to the standard format in
float32 by each package's ops/geometry.yx_zb_to_standard)."""

import numpy as np

from detection_3d_tpu.data.export import predictions_to_txt as j_export
from detection_3d_tpu_torch.data.export import predictions_to_txt


def _predictions():
    rng = np.random.RandomState(0)
    out = []
    for n in (5, 0, 12):
        boxes = np.c_[rng.uniform(0, 30, (n, 3)), rng.uniform(0.1, 4, (n, 3)),
                      rng.uniform(-1.6, 1.6, (n, 1))].astype(np.float32)
        out.append({"boxes": boxes, "labels": rng.randint(1, 6, n)})
    return out


def test_files_equal_jax(tmp_path):
    preds = _predictions()
    got = predictions_to_txt(preds, str(tmp_path / "port"))
    want = j_export(preds, str(tmp_path / "jax"))
    assert [p.split("/")[-1] for p in got] == \
        [p.split("/")[-1] for p in want] == ["room_0.txt", "room_1.txt",
                                             "room_2.txt"]
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()
    rows = np.loadtxt(got[2])
    assert rows.shape == (12, 8)
    np.testing.assert_array_equal(rows[:, 7], preds[2]["labels"])
