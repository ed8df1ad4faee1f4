"""The ``labelled_train`` window: the ``train`` window (windows/train.py)
over a pool whose points carry labels, as a segmentation network trains.
The pool's buildings carry boxes; before the train window starts, set-up
labels each building's points once by its boxes on the run's card
(traffic/box_labels.label_scene) and keeps them in the building as
``point_labels``, which ``engine/trainer.pad_scene`` carries into the
step. The timed window is the train window's own, on labelled
buildings; the reference pads the same labelled buildings."""

from __future__ import annotations

from typing import Dict


def window(run) -> Dict:
    """Label the pool (module docstring), then run the train window."""
    from perfbench import spec
    from perfbench.traffic.box_labels import label_scene
    for scene in run.pool:
        if "point_labels" not in scene:
            scene["point_labels"] = label_scene(scene, run.device)
    return spec.window(run.cell.root, "train")(run)
