"""Buildings in the program's ``model.replay`` spans of the traced
sub-window over those in the ``model.predict`` spans holding them, %:
the share of the served buildings whose forward replayed a CUDA graph
(engine/inference.GraphedForward). None where no forward replayed, as in
a program without graphs. It serves every metric
``replay_share.<part>``."""

from perfbench.spans import named


def read(run):
    replays = named(run, "model.replay")
    predicts = named(run, "model.predict")
    if replays is None or predicts is None:
        return None
    held = {r.id for r in predicts}
    return 100.0 * sum(r.buildings for r in replays if r.parent in held) \
        / sum(r.buildings for r in predicts)
