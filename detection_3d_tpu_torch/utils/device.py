"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


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
