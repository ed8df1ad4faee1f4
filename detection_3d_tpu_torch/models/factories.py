"""Generic sparse networks: UNet, VGG and fully convolutional builders,
and dropout.

Counterpart of detection_3d_tpu/models/factories.py (SparseConvNet's
networkArchitectures.py: SparseVggNet:9, UNet:203,
FullyConvolutionalNet:259, and dropout.py). The detector uses the
specialised SparseFPN (models/backbone.py); these give users the
building blocks the reference library ships, over the port's sparse
ops:

  * planning is separate from the network: :func:`plan_levels` builds
    every level's table and rulebooks once, and the modules read the
    plan (SCN's Metadata rulebook cache, made explicit);
  * every conv is bias-free and runs on kernel A on the card (A' in the
    backward), with each book's row order from the plan; BN + leaky ReLU
    supplies the shift and the nonlinearity;
  * UNet joins are concatenations (SCN JoinTable).

Submodules and parameters carry the Flax names (``enc0_conv0.w``,
``down0.bn.scale``, ``dec0_res0.shortcut.w``, ...), so
utils/convert.convert_jax_params plus ``load_state_dict(strict=True)``
loads a JAX parameter tree unchanged. Torch needs every width when a
module is built, so each factory takes ``in_channels`` (the plan's
input width) and ``kernel_volume`` (the plan's downsample kernel, 8 for
plan_levels' default 2 x 2 x 2), which Flax reads off its inputs.
Weights start from ``seed`` (SCN's fan-in init, as the detector's).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from detection_3d_tpu_torch.models.backbone import (
    BNLeakyReLU, DownLayer, ResidualBlock, SubmConv, UpLayer, pyramid_levels,
)
from detection_3d_tpu_torch.ops.sparse import SparseTensor
from detection_3d_tpu_torch.ops.sparse_pool import max_pool


def plan_levels(table0: SparseTensor, caps: Sequence[int],
                kernel: Tuple[int, int, int] = (2, 2, 2),
                stride: Tuple[int, int, int] = (2, 2, 2),
                dense_grid_budget: int = 1 << 26,
                backward: bool = False) -> Dict[str, Any]:
    """Tables and rulebooks of ``len(caps)`` levels (level 0 = the input
    table), built as models/backbone.build_pyramid builds the detector's
    (:func:`models.backbone.pyramid_levels`).

    Returns {"tables", "subm_idx", "down_rb", "up_rb", "subm_order",
    "down_order", "up_order"} and, with ``backward`` (a forward whose
    gradient is wanted), {"subm_bwd", "down_bwd", "up_bwd"}; every list
    is in level order, so ``up_rb[k]`` maps level k + 1 back to level k
    (deconv and unpool). The strided and deconv books are scatters of the
    downsample's dedup sort, the 3x3x3 submanifold books come from kernel
    B on the card (its column algorithm on the CPU), and every book has
    its RowOrder for kernel A.

    ``dense_grid_budget`` is kept for the JAX signature and unused: the
    JAX package answers submanifold lookups from a dense grid when it
    fits, the port always by search, and the books are equal bit for
    bit either way.
    """
    del dense_grid_budget
    n = len(caps)
    return pyramid_levels(table0, (kernel,) * (n - 1), (stride,) * (n - 1),
                          caps, backward)


def _level(plan, k):
    """(book, valid, order, backward book) of level k's submanifold
    conv."""
    bwd = plan.get("subm_bwd")
    return (plan["subm_idx"][k], plan["tables"][k].row_valid,
            plan["subm_order"][k], None if bwd is None else bwd[k])


def _down(plan, k):
    """(book, order, backward book) of downsample k (level k -> k + 1)."""
    bwd = plan.get("down_bwd")
    return (plan["down_rb"][k], plan["down_order"][k],
            None if bwd is None else bwd[k])


def _up(plan, k):
    """(book, order, backward book) of the deconv level k + 1 -> k."""
    bwd = plan.get("up_bwd")
    return (plan["up_rb"][k], plan["up_order"][k],
            None if bwd is None else bwd[k])


class _Initialised(nn.Module):
    def reset_parameters(self, seed: int):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)


class SparseDropout(nn.Module):
    """Feature dropout on active rows (SCN dropout.py): kept entries
    scaled by 1 / (1 - rate), the identity when ``deterministic`` or the
    rate is 0; invalid rows pass through. ``per_channel=False`` drops
    whole rows (SCN's BatchwiseDropout). The keep mask is drawn from
    ``generator`` (torch.bernoulli on the features' device), so it is
    not JAX's draw."""

    def __init__(self, rate: float, per_channel: bool = True):
        super().__init__()
        self.rate = rate
        self.per_channel = per_channel

    def forward(self, feats, valid, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if deterministic or self.rate <= 0.0:
            return feats
        shape = feats.shape if self.per_channel else (feats.shape[0], 1)
        p = torch.full(shape, 1.0 - self.rate, dtype=torch.float32,
                       device=feats.device)
        keep = torch.bernoulli(p, generator=generator)
        out = feats * keep.to(feats.dtype) / (1.0 - self.rate)
        return torch.where(valid[:, None], out, feats)


class SparseUNet(_Initialised):
    """Recursive encoder / decoder with concatenation joins (SCN UNet,
    networkArchitectures.py:203-258): ``reps`` blocks a level, a strided
    2x conv down, a deconv up, the join, then ``reps`` blocks.

    forward(plan, feats=None) -> (V_0, nplanes[0]) features on level 0
    (``feats`` defaults to the plan's level-0 table features)."""

    def __init__(self, in_channels: int, nplanes: Sequence[int],
                 reps: int = 1, residual: bool = False,
                 leakiness: float = 0.0, kernel_volume: int = 8,
                 seed: int = 0):
        super().__init__()
        self.nplanes = tuple(nplanes)
        self.reps = reps
        self.residual = residual
        n = len(self.nplanes)

        def build(k, cin):      # the modules of level k; its output width
            c = self._add_blocks(f"enc{k}", cin, self.nplanes[k], leakiness)
            if k == n - 1:
                return c
            self.add_module(f"down{k}", DownLayer(c, self.nplanes[k + 1],
                                                  kernel_volume))
            below = build(k + 1, self.nplanes[k + 1])
            self.add_module(f"up{k}", UpLayer(below, self.nplanes[k],
                                              kernel_volume))
            return self._add_blocks(f"dec{k}", c + self.nplanes[k],
                                    self.nplanes[k], leakiness)

        build(0, in_channels)
        self.reset_parameters(seed)

    def _add_blocks(self, tag, cin, cout, leakiness):
        for r in range(self.reps):
            if self.residual:
                self.add_module(f"{tag}_res{r}", ResidualBlock(cin, cout))
            else:
                self.add_module(f"{tag}_bn{r}", BNLeakyReLU(cin, leakiness))
                self.add_module(f"{tag}_conv{r}", SubmConv(cin, cout))
            cin = cout
        return cin

    def _blocks(self, tag, h, plan, k):
        idx, valid, order, bwd = _level(plan, k)
        for r in range(self.reps):
            if self.residual:
                h = getattr(self, f"{tag}_res{r}")(h, idx, valid, order, bwd)
            else:
                h = getattr(self, f"{tag}_bn{r}")(h, valid)
                h = getattr(self, f"{tag}_conv{r}")(h, idx, valid, order,
                                                    bwd)
        return h

    def forward(self, plan: Dict[str, Any], feats=None):
        tables = plan["tables"]
        n = len(self.nplanes)
        if len(tables) < n:
            raise ValueError(f"the plan has {len(tables)} levels, the net "
                             f"{n}")
        valids = [t.row_valid for t in tables]

        def level(k, h):
            h = self._blocks(f"enc{k}", h, plan, k)
            if k == n - 1:
                return h
            rb, order, bwd = _down(plan, k)
            d = getattr(self, f"down{k}")(h, rb, valids[k], valids[k + 1],
                                          order, bwd)
            d = level(k + 1, d)
            rb, order, bwd = _up(plan, k)
            u = getattr(self, f"up{k}")(d, rb, valids[k + 1], valids[k],
                                        order, bwd)
            h = torch.cat([h, u], dim=-1)            # JoinTable
            return self._blocks(f"dec{k}", h, plan, k)

        return level(0, tables[0].feats if feats is None else feats)


class SparseVGG(_Initialised):
    """Spec-driven sequential net (SCN SparseVggNet,
    networkArchitectures.py:9-41). ``layers`` entries:

      ("C", c)     3^3 submanifold conv to c channels + BN-LReLU
      ("MP",)      max pool over the next downsample's book (kernel 2^3,
                   stride 2 in plan_levels' default) to the next level
      ("C3/2", c)  strided 2x conv to c channels (BN-LReLU first)

    Pools and strided convs consume successive plan levels. forward(plan,
    feats=None) -> (features, level)."""

    def __init__(self, in_channels: int, layers: Sequence,
                 leakiness: float = 0.0, kernel_volume: int = 8,
                 seed: int = 0):
        super().__init__()
        self.ops = []
        c = in_channels
        for i, spec in enumerate(layers):
            op = spec[0] if isinstance(spec, (tuple, list)) else spec
            if op == "C":
                self.add_module(f"l{i}_conv", SubmConv(c, spec[1]))
                self.add_module(f"l{i}_bn", BNLeakyReLU(spec[1], leakiness))
                c = spec[1]
            elif op == "C3/2":
                self.add_module(f"l{i}_down",
                                DownLayer(c, spec[1], kernel_volume))
                c = spec[1]
            elif op != "MP":
                raise ValueError(f"unknown VGG spec entry {spec!r}")
            self.ops.append(op)
        self.reset_parameters(seed)

    def forward(self, plan: Dict[str, Any], feats=None):
        tables = plan["tables"]
        h = tables[0].feats if feats is None else feats
        lvl = 0
        for i, op in enumerate(self.ops):
            if op == "C":
                idx, valid, order, bwd = _level(plan, lvl)
                h = getattr(self, f"l{i}_conv")(h, idx, valid, order, bwd)
                h = getattr(self, f"l{i}_bn")(h, valid)
            elif op == "MP":
                h = max_pool(h, plan["down_rb"][lvl],
                             tables[lvl + 1].row_valid)
                lvl += 1
            else:
                rb, order, bwd = _down(plan, lvl)
                h = getattr(self, f"l{i}_down")(
                    h, rb, tables[lvl].row_valid, tables[lvl + 1].row_valid,
                    order, bwd)
                lvl += 1
        return h, lvl


class FullyConvolutionalNet(_Initialised):
    """Encoder whose every level is upsampled back to level 0 and
    concatenated there (SCN FullyConvolutionalNet,
    networkArchitectures.py:259-297); each level keeps its width on the
    way up, so the output has sum(nplanes) channels."""

    def __init__(self, in_channels: int, nplanes: Sequence[int],
                 reps: int = 1, leakiness: float = 0.0,
                 kernel_volume: int = 8, seed: int = 0):
        super().__init__()
        self.nplanes = tuple(nplanes)
        self.reps = reps
        n = len(self.nplanes)
        c = in_channels
        for k in range(n):
            for r in range(reps):
                self.add_module(f"enc{k}_bn{r}", BNLeakyReLU(c, leakiness))
                self.add_module(f"enc{k}_conv{r}",
                                SubmConv(c, self.nplanes[k]))
                c = self.nplanes[k]
            up = c
            for j in range(k - 1, -1, -1):
                self.add_module(f"up{k}_{j}",
                                UpLayer(up, self.nplanes[k], kernel_volume))
                up = self.nplanes[k]
            if k < n - 1:
                self.add_module(f"down{k}", DownLayer(
                    c, self.nplanes[k + 1], kernel_volume))
                c = self.nplanes[k + 1]
        self.reset_parameters(seed)

    def forward(self, plan: Dict[str, Any], feats=None):
        tables = plan["tables"]
        n = len(self.nplanes)
        valids = [t.row_valid for t in tables]
        h = tables[0].feats if feats is None else feats
        outs = []
        for k in range(n):
            idx, valid, order, bwd = _level(plan, k)
            for r in range(self.reps):
                h = getattr(self, f"enc{k}_bn{r}")(h, valid)
                h = getattr(self, f"enc{k}_conv{r}")(h, idx, valid, order,
                                                     bwd)
            up = h
            for j in range(k - 1, -1, -1):    # deconvs back to level 0
                rb, order_j, bwd_j = _up(plan, j)
                up = getattr(self, f"up{k}_{j}")(up, rb, valids[j + 1],
                                                 valids[j], order_j, bwd_j)
            outs.append(up)
            if k < n - 1:
                rb, order_k, bwd_k = _down(plan, k)
                h = getattr(self, f"down{k}")(h, rb, valids[k],
                                              valids[k + 1], order_k, bwd_k)
        return torch.cat(outs, dim=-1)
