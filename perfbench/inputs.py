"""The model's weights, which a run hands the program and the reference
alike: made from the run's seed on the device, one large draw from one
``torch.Generator`` (the buildings come from traffic/pool.py)."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch


def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 init_std: Callable[[str, tuple], float]
                 ) -> Dict[str, torch.Tensor]:
    """float32 weights of the named ``shapes`` on ``device``: the vectors
    named ``*scale`` ones, the other vectors zeros, the matrices one
    normal draw from a generator on ``device`` seeded by ``seed``, cut
    and scaled by ``init_std(name, shape)`` (the family's)."""
    device = torch.device(device)
    mats = {k: s for k, s in shapes.items() if len(s) >= 2}
    total = sum(math.prod(s) for s in mats.values())
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    draw = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) >= 2:
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape) * init_std(name, shape)
            at += n
        elif name.endswith("scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def meta_model(model_cls, cfg):
    """``model_cls(cfg)`` on the meta device: its modules and shapes,
    no storage, its own initialisation skipped."""
    with torch.device("meta"):
        return model_cls(cfg)


def load(model, weights: Dict[str, torch.Tensor], device):
    """A meta ``model`` given storage on ``device`` and ``weights``, in
    eval mode."""
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()
