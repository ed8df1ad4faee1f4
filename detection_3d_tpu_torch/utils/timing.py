"""Per-stage wall-clock timing of one forward on the card."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class PhaseTimer:
    """Accumulates seconds per named stage. Each stage is bracketed by
    ``torch.cuda.synchronize`` when the device is a GPU, so a stage's time
    includes its device work; the synchronisation serialises the
    forward, so time requests with the timer off."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] = self.seconds.get(name, 0.0) + \
                time.perf_counter() - t0
