"""Dataset class<->label metas, canonical SUNCG ordering.

Parity with SUNCG_METAS
(reference data3d/suncg_utils/suncg_metas.py:2-43): the canonical
class order is background, wall, window, door, floor, ceiling, room —
labels are assigned by CANONICAL position among the selected classes, not
by the order they appear in the config.
"""

from __future__ import annotations

from typing import Dict, Sequence

CANONICAL_ORDER = ("background", "wall", "window", "door", "floor",
                   "ceiling", "room")


class DatasetMetas:
    def __init__(self, classes: Sequence[str]):
        assert "background" in classes
        for c in classes:
            assert c in CANONICAL_ORDER, f"{c} is not a valid class name"
        self.classes = tuple(classes)
        self.class_2_label: Dict[str, int] = {}
        self.label_2_class: Dict[int, str] = {}
        l = 0
        for c in CANONICAL_ORDER:
            if c in classes:
                self.class_2_label[c] = l
                self.label_2_class[l] = c
                l += 1
        self.num_classes = len(classes)

    def ordered_classes(self):
        return tuple(self.label_2_class[i] for i in range(self.num_classes))
