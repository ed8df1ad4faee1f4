"""Flax parameter tree -> PyTorch state_dict.

The port's modules carry the names of the JAX package's Flax modules and
their parameters (``params["params"]["backbone"]["block0_0"]["conv1"]
["w"]`` is ``backbone.block0_0.conv1.w``), and keep the same layouts
(sparse conv weights (K, Cin, Cout), dense weights (Cin, Cout)), so the
conversion is a flatten of the nested dicts with no transposes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def convert_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays (optionally under a top-level "params"
    collection) -> {dotted name: f32 tensor}. Raises when two leaves map
    to one name or a key holds a dot, so every leaf is used exactly
    once; ``load_state_dict(strict=True)`` then checks that the names
    and shapes match the model one to one."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if "." in key:
                raise ValueError(f"parameter key {key!r} contains a dot")
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(val, name)
                continue
            if name in out:
                raise ValueError(f"parameter {name!r} appears twice")
            out[name] = torch.from_numpy(
                np.array(val, dtype=np.float32, copy=True))
    walk(params, "")
    return out
