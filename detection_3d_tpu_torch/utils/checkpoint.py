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

:func:`load_jax_checkpoint` reads a ``.msgpack`` file of the JAX
package's Checkpointer (``flax.serialization.to_bytes``) with plain
``msgpack``, so a model trained there loads into the port.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import numpy as np
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


# flax.serialization's msgpack extension codes for arrays and numpy
# scalars; a model's state holds no other
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """Flax's array encoding: packb((shape, dtype name, C-order bytes));
    bfloat16, which numpy lacks, comes back as float32 (exact)."""
    import msgpack
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"msgpack extension {code} is not a flax array or "
                     "numpy scalar")


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The state a JAX ``Checkpointer.save`` wrote to ``path``
    (detection_3d_tpu/utils/checkpoint.py): nested dicts of numpy arrays
    and scalars, as flax's state dicts hold them ({"params": {"params":
    ...}, "opt_state": ..., "step": ...} for a trainer's checkpoint;
    tuples such as an optax state are dicts keyed "0", "1", ...)."""
    import msgpack
    with open(path, "rb") as f:
        data = f.read()
    return msgpack.unpackb(data, ext_hook=_ext_hook, raw=False)
