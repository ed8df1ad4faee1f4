"""Device selection for the port's entry points, and constants on the
card."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def device_constant(values, dtype, device) -> torch.Tensor:
    """A tensor of nested Python numbers ``values`` (tuples) on
    ``device``, made once per (values, dtype, device) and shared by every
    later call; callers must not write to it. A fresh ``torch.tensor`` on
    the card is a host-to-device copy that waits for the card, and a
    serving forward must queue its whole unit without waiting."""
    key = (values, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        # a normal tensor even when first made under inference_mode, so
        # that a later forward with autograd may index with it
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype,
                                               device=device)
    return t


def resolve_device(device="cuda") -> torch.device:
    """The entry points run on the card unless the caller asks for the
    CPU; asking for CUDA without a card raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def card_info(device="cuda") -> dict:
    """The card a tool measures on: ``{"name", "power_limit_w", "line"}``,
    ``line`` as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it for the card's index. A card's
    power limit may be set below its maximum, and it then runs slower
    under load, so every number a tool prints goes beside this line. On
    the CPU: name "cpu" and no power limit. Raises when CUDA is asked
    for and absent, or when nvidia-smi cannot read the card."""
    import subprocess
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "line": "cpu"}
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    limit = line.rsplit(",", 1)[1].strip().split()[0]
    return {"name": torch.cuda.get_device_name(dev),
            "power_limit_w": float(limit), "line": line}
