"""The port's YAML loader (config/yaml_loader.py) against the JAX
package's: the same YAML file gives equal configs, field by field, and
the same unknown keys warn.

Files: the miniature reference overlay of tests/test_config.py, and one
that sets every key of the loader's mapping (lists, python-tuple
strings, numbers, booleans and strings) plus keys that are ignored with
and without a warning.
"""

import dataclasses
import logging

import pytest
import yaml

from detection_3d_tpu.config import yaml_loader as jyaml
from detection_3d_tpu_torch.config import Config, load_yaml_config
from detection_3d_tpu_torch.config import yaml_loader as tyaml

REFERENCE_OVERLAY = """
INPUT:
  CLASSES: ['background', 'wall', 'door', 'window']
MODEL:
  RPN:
    ANCHOR_SIZES_3D: [[0.4,1.5,1.5], [0.2,0.5,3], [0.4,1.5,3], [0.6,2.5,3]]
    RPN_SCALES_FROM_TOP: [4,3,2]
    BG_IOU_THRESHOLD: 0.2
  ROI_BOX_HEAD:
    POOLER_RESOLUTION: (6,8,4)
SPARSE3D:
  VOXEL_FULL_SCALE: [4096, 4096, 512]
SOLVER:
  BASE_LR: 0.005
  LR_STEP_EPOCHS: (100,)
TEST:
  IOU_THRESHOLD: 0.2
OUTPUT_DIR: "RES/x"
"""


def _value_for(tree, name, i):
    """A value of the field's type that differs from its default."""
    default = getattr(Config() if not tree else getattr(Config(), tree), name)
    if isinstance(default, bool):
        return not default
    if isinstance(default, int):
        return default + 3 + i
    if isinstance(default, float):
        return round(default + 0.125 * (i + 1), 6)
    if isinstance(default, str):
        return f"value_{i}"
    if name in ("classes", "elements", "scenes"):
        return {"classes": ["background", "wall", "floor"],
                "elements": ["xyz", "normal"],
                "scenes": ["house_a", "house_b"]}[name]
    if name == "separate_classes":
        return [["wall"], ["floor"]]
    if default and isinstance(default[0], tuple):
        # tuples of tuples, written as a python-tuple string
        return str(tuple(tuple(v + 1 for v in row) for row in default))
    if default:
        return [v + 1 for v in default]
    return [1, 2]


def _every_key_yaml():
    raw = {}
    for i, ((section, key), (tree, name)) in enumerate(
            sorted(jyaml._MAPPING.items())):
        node = raw
        for part in section.split(".") if section else ():
            node = node.setdefault(part, {})
        node[key] = _value_for(tree, name, i)
    raw.setdefault("DEBUG", {})["unused_debug_key"] = 1
    raw["DATASETS"] = {"TRAIN": ["x"]}
    raw["MODEL"]["NOT_A_KEY"] = 5
    return yaml.safe_dump(raw)


CASES = {"reference_overlay": REFERENCE_OVERLAY,
         "every_key": _every_key_yaml()}


def test_mapping_is_the_jax_mapping():
    assert tyaml._MAPPING == jyaml._MAPPING


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_yaml_gives_equal_configs(case, tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(CASES[case])
    want = jyaml.load_yaml_config(str(path))
    got = load_yaml_config(str(path))
    want_d, got_d = dataclasses.asdict(want), dataclasses.asdict(got)
    assert set(got_d) == set(want_d)
    for field in want_d:
        assert got_d[field] == want_d[field], field
    hash(got)    # every value is a tuple, as in the JAX config


def test_every_key_moves_its_field(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(CASES["every_key"])
    got, base = load_yaml_config(str(path)), Config()
    for tree, name in tyaml._MAPPING.values():
        old = getattr(base if not tree else getattr(base, tree), name)
        new = getattr(got if not tree else getattr(got, tree), name)
        assert new != old, (tree, name)


def test_base_config_is_overlaid(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("SOLVER:\n  EPOCHS: 3\n")
    base = Config(compute_dtype="float32")
    got = load_yaml_config(str(path), base=base)
    assert got.compute_dtype == "float32" and got.solver.epochs == 3
    assert got.replace(solver=base.solver) == base


def test_unknown_keys_warn_as_in_jax(tmp_path, caplog):
    path = tmp_path / "c.yaml"
    path.write_text(CASES["every_key"])
    warned = {}
    for name, mod in (("jax", jyaml), ("port", tyaml)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            mod.load_yaml_config(str(path))
        warned[name] = sorted(r.getMessage() for r in caplog.records
                              if "unknown config key" in r.getMessage())
    assert warned["port"] == warned["jax"]
    assert warned["port"] == ["ignoring unknown config key "
                              "('MODEL', 'NOT_A_KEY')"]


def test_missing_pyyaml_raises_the_jax_error(tmp_path, monkeypatch):
    import sys
    path = tmp_path / "c.yaml"
    path.write_text("SOLVER:\n  EPOCHS: 3\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="pyyaml is required"):
        load_yaml_config(str(path))
