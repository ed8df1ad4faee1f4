"""Checkpointing with an auto-resume tag.

Counterpart of detection_3d_tpu/utils/checkpoint.py (reference
utils/checkpoint.py:13-100), with ``torch.save`` files instead of Flax
msgpack:
  * ``save(name, state)`` writes one ``<name>.pt`` file (a dict of state
    dicts, tensors and numbers: the trainer saves the model, the
    optimizer state and the step);
  * a ``last_checkpoint`` tag file records the basename of the latest
    save, so ``load()`` resumes from it, and the tag beats an explicit
    path; the tag resolves against ``save_dir``, so a moved output
    directory still resumes;
  * ``prune(keep_last)`` deletes stale periodic snapshots.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import torch


class Checkpointer:
    def __init__(self, save_dir: str, logger=None):
        self.save_dir = save_dir
        self.logger = logger
        os.makedirs(save_dir, exist_ok=True)

    def _tag_file(self):
        return os.path.join(self.save_dir, "last_checkpoint")

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._tag_file())

    def get_checkpoint_file(self) -> str:
        try:
            with open(self._tag_file()) as f:
                return f.read().strip()
        except OSError:
            return ""

    def _resolve(self, name: str) -> str:
        return name if os.path.isabs(name) else \
            os.path.join(self.save_dir, name)

    def save(self, name: str, state: Dict[str, Any]) -> str:
        path = os.path.join(self.save_dir, f"{name}.pt")
        torch.save(state, path)
        with open(self._tag_file(), "w") as f:
            f.write(os.path.basename(path))
        if self.logger:
            self.logger.info("Saved checkpoint to %s", path)
        return path

    def load(self, template: Optional[Dict[str, Any]] = None,
             path: Optional[str] = None, map_location="cpu"):
        """The saved state dict, or ``template`` when there is none.
        Auto-resume from the tag beats the explicit ``path``."""
        if self.has_checkpoint():
            resume = self._resolve(self.get_checkpoint_file())
            if path and self.logger and os.path.abspath(path) != \
                    os.path.abspath(resume):
                self.logger.warning(
                    "auto-resume from %s overrides explicitly requested "
                    "weights %s (delete the last_checkpoint tag to force "
                    "the explicit path)", resume, path)
            path = resume
        if not path or not os.path.exists(path):
            if self.logger:
                self.logger.info("No checkpoint found; starting fresh")
            return template
        state = torch.load(path, map_location=map_location,
                           weights_only=True)
        if self.logger:
            self.logger.info("Loaded checkpoint from %s", path)
        return state

    def prune(self, keep_last: int = 0) -> list:
        """Delete every ``model_*.pt`` except the tagged last checkpoint,
        ``model_final`` and ``model_min_loss``; ``keep_last`` also spares
        the N newest periodic snapshots. Returns the removed paths."""
        keep = {os.path.join(self.save_dir, "model_final.pt"),
                os.path.join(self.save_dir, "model_min_loss.pt")}
        tagged = self.get_checkpoint_file()
        if tagged:
            keep.add(self._resolve(tagged))
        snaps = sorted(p for p in glob.glob(
            os.path.join(self.save_dir, "model_*.pt")) if p not in keep)
        if keep_last > 0:
            snaps = snaps[:-keep_last]
        for p in snaps:
            os.remove(p)
            if self.logger:
                self.logger.info("pruned stale checkpoint %s", p)
        return snaps
