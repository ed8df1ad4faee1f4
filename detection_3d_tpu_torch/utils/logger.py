"""Rank-aware file + stdout logger.

A copy of detection_3d_tpu/utils/logger.py (reference utils/logger.py
semantics): the first call for a name sets it up at INFO with a stdout
handler and, given ``save_dir``, a ``log.txt`` file handler; later calls
return the same logger; ranks above 0 get no handlers.
"""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(name: str, save_dir: str = "", rank: int = 0):
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    if rank > 0:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
