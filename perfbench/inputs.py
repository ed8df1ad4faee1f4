"""The model's weights, which a run hands the program and the reference
alike: made from the run's seed on the device, one large draw from one
``torch.Generator`` (the buildings come from traffic/pool.py)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def _init_std(name: str, shape) -> float:
    """The benchmark's initialisation, the program's rule in scale: the
    RPN head and the ROI classifier N(0, 0.01), the ROI box regressor
    N(0, 0.001), every other weight He's N(0, 2 / fan_in) with fan_in
    the product of all but the last dimension."""
    if name.startswith("rpn.head."):
        return 0.01
    if name.endswith("predictor.cls_w"):
        return 0.01
    if name.endswith("predictor.box_w"):
        return 0.001
    return math.sqrt(2.0 / math.prod(shape[:-1]))


def make_weights(shapes: Dict[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 weights of the named ``shapes`` on ``device``: the vectors
    named ``*scale`` ones, the other vectors zeros, the matrices one
    normal draw from a generator on ``device`` seeded by ``seed``, cut
    and scaled by :func:`_init_std`."""
    device = torch.device(device)
    mats = {k: s for k, s in shapes.items() if len(s) >= 2}
    total = sum(math.prod(s) for s in mats.values())
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    draw = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) >= 2:
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape) * _init_std(name, shape)
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
