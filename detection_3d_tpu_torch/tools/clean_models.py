"""Prune stale checkpoint snapshots from output directories.

    python -m detection_3d_tpu_torch.tools.clean_models RES/run_a RES/run_b
    python -m detection_3d_tpu_torch.tools.clean_models --keep-last 2 'RES/res*'

Counterpart of the repo-level tools/clean_models.py (reference
clean_models.py:1-20) for the port's ``model_*.pt`` checkpoints: in each
run directory (globs expanded) every periodic snapshot is removed except
the tagged last checkpoint, ``model_final`` and ``model_min_loss``
(utils/checkpoint.Checkpointer.prune); ``--keep-last N`` also spares
the N newest. A ``log.txt`` is first copied to ``_log.txt``. A path that
is not a directory is skipped with a warning. Needs no device.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys


def main(argv=None) -> int:
    from detection_3d_tpu_torch.utils.checkpoint import Checkpointer
    from detection_3d_tpu_torch.utils.logger import setup_logger
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="+",
                    help="run output directories (globs ok)")
    ap.add_argument("--keep-last", type=int, default=0,
                    help="also spare the N newest periodic snapshots")
    args = ap.parse_args(argv)
    logger = setup_logger("clean_models")
    dirs = []
    for p in args.paths:
        dirs += sorted(glob.glob(p)) or [p]
    removed = 0
    for d in dirs:
        if not os.path.isdir(d):
            logger.warning("skipping %s: not a directory", d)
            continue
        log = os.path.join(d, "log.txt")
        if os.path.exists(log):      # reference clean_models.py:8-9
            shutil.copyfile(log, os.path.join(d, "_log.txt"))
        gone = Checkpointer(d, logger).prune(keep_last=args.keep_last)
        removed += len(gone)
        logger.info("%s: clean ok (%d removed)", d, len(gone))
    logger.info("total removed: %d", removed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
