"""The plain reference of MinkUNet34C's training step: NVIDIA
MinkowskiEngine's ``examples/minkunet.py`` (Choy, Gwak and Savarese,
CVPR 2019) written out in plain PyTorch, float32, with autograd for the
gradients of everything but the sparse conv. It reads nothing of the
port: books come from a coordinate lookup (each voxel's key searched
among a level's sorted keys), a sparse conv is a gather, a matmul and a
scatter-add per offset, and its backward (:class:`BookConv`) is written
out the same way, so that the gathered rows are made again rather than
kept and a full-size step fits the card (the repo's tests hold it to
autograd of the same gather, matmul and scatter-add), BN takes the batch
statistics of the active voxels, and the loss is the mean cross-entropy
over the labelled voxels. Its parameters carry the
program's names and shapes (``conv0p1s1.w`` (125, 3, 32), ...,
``final.w``, ``final.bias``), so one set of weights loads into both.

Layers, as the program's models/minkunet.py states them::

    p1 = ReLU(BN(conv5^3(x)))
    e_k = block_k(ReLU(BN(conv2^3/s2(e_{k-1}))))          k = 1..4
    d_j = block_{8-j}(cat(ReLU(BN(convT2^3/s2(d_{j+1}))), e_j))
    out = conv1^3(d_0) + bias

Where it departs from MinkowskiEngine, each on purpose and the same in
the program:

  * a voxel's features are the mean of its points' (ME's
    ``UNWEIGHTED_AVERAGE`` quantization mode; its default keeps one
    point);
  * a voxel's label is the one its points share; a voxel whose points
    disagree, or carry none (-1), is ignored (ME's examples take one
    point's label);
  * a stride-2 conv's offset k is ((x % 2) * 2 + y % 2) * 2 + z % 2 of
    the finer voxel, and a 3^3 or 5^3 book's offsets run dx outer, dz
    inner; the transposed conv reads each finer voxel's parent at that
    voxel's offset;
  * BN (torch's batch_norm in training) normalises by the batch's
    biased variance at eps 1e-5 (ME's), as ME trains;
  * the weights come from the benchmark's seed (inputs.make_weights:
    He's normal over fan-in, BN scales 1, biases 0), not ME's kaiming
    normal over fan-out;
  * no table cap: every voxel is kept (the configuration's caps are
    above the voxels its buildings have; a program that drops voxels
    fails the check).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.config import CapacityConfig, SolverConfig

LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
INIT_DIM = 32
LEVELS = 5
BN_EPS = 1e-5
_WIDTH = 3      # each of xyz, color, normal


@dataclass(frozen=True)
class Config:
    """The reference's configuration: the program's fields
    (models/minkunet.MinkUNetConfig), read from the same file."""
    classes: Tuple[str, ...] = ("background", "wall", "door", "window",
                                "ceiling", "floor")
    elements: Tuple[str, ...] = ("xyz", "color")
    out_channels: int = 20
    layers: Tuple[int, ...] = LAYERS
    planes: Tuple[int, ...] = PLANES
    init_dim: int = INIT_DIM
    compute_dtype: str = "float32"
    voxel_full_scale: Tuple[int, int, int] = (4096, 4096, 512)
    solver: SolverConfig = field(default_factory=SolverConfig)
    caps: CapacityConfig = field(default_factory=lambda: CapacityConfig(
        voxel_caps=(524288, 524288, 524288, 262144, 65536), max_gt=512))
    output_dir: str = "./RES"

    @property
    def in_channels(self) -> int:
        return _WIDTH * len(self.elements)

    def validate(self) -> "Config":
        assert len(self.layers) == len(self.planes) == 8
        return self


def pad_scene(cfg: Config, scene: Dict) -> Dict[str, np.ndarray]:
    """A building's points, the ``elements`` columns of its features, its
    gt boxes and (when it has them) its points' labels padded to the
    configuration's capacities; pad labels are -1."""
    n, g = cfg.caps.max_points, cfg.caps.max_gt
    m = min(scene["points"].shape[0], n)
    mg = min(scene["gt_boxes"].shape[0], g)
    out = {"points": np.zeros((n, 3), np.float32),
           "feats": np.zeros((n, cfg.in_channels), np.float32),
           "points_valid": np.arange(n) < m,
           "gt_boxes": np.zeros((g, 7), np.float32),
           "gt_labels": np.zeros((g,), np.int32),
           "gt_valid": np.arange(g) < mg}
    out["points"][:m] = scene["points"][:m]
    out["feats"][:m] = scene["feats"][:m, :cfg.in_channels]
    out["gt_boxes"][:, 3:6] = 0.1
    out["gt_boxes"][:mg] = scene["gt_boxes"][:mg]
    out["gt_labels"][:mg] = scene["gt_labels"][:mg]
    if "point_labels" in scene:
        out["point_labels"] = np.full((n,), -1, np.int32)
        out["point_labels"][:m] = scene["point_labels"][:m]
    return out


# -- levels and books -------------------------------------------------------

def _keys(coords, size):
    return (coords[:, 0] * size[1] + coords[:, 1]) * size[2] + coords[:, 2]


class Level:
    """One level's voxels: ``coords`` (n, 3) int64 sorted by key, the
    grid ``size``, and ``parent`` (n,) the row of each voxel's parent on
    the next level (set when that level is made)."""

    def __init__(self, coords, size):
        self.coords, self.size = coords, tuple(size)
        self.keys = _keys(coords, self.size)
        self.parent = None

    @property
    def n(self) -> int:
        return self.coords.shape[0]

    def lookup(self, query):
        """The row of each (m, 3) query voxel, -1 where it is absent or
        out of the grid."""
        size = torch.tensor(self.size, device=query.device)
        inside = ((query >= 0) & (query < size)).all(1)
        q = _keys(query.clamp(min=0), self.size)
        pos = torch.searchsorted(self.keys, q).clamp(max=max(self.n - 1, 0))
        hit = inside & (self.n > 0) & (self.keys[pos] == q)
        return torch.where(hit, pos, -1)

    def coarser(self) -> "Level":
        """The stride-2 level above: every voxel's parent at floor(x / 2)."""
        up, inverse = torch.unique(_keys(self.coords // 2, _half(self.size)),
                                   sorted=True, return_inverse=True)
        self.parent = inverse
        size = _half(self.size)
        coords = torch.stack([up // (size[1] * size[2]),
                              (up // size[2]) % size[1], up % size[2]], 1)
        return Level(coords, size)

    def cube_book(self, side: int) -> List[Tuple]:
        """The submanifold book of the side^3 offsets, dx outer, dz
        inner: per offset, the (input rows, output rows) it pairs."""
        r = side // 2
        rows = torch.arange(self.n, device=self.coords.device)
        out = []
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                for dz in range(-r, r + 1):
                    d = torch.tensor([dx, dy, dz], device=self.coords.device)
                    src = self.lookup(self.coords + d)
                    hit = src >= 0
                    out.append((src[hit], rows[hit]))
        return out

    def sample_book(self) -> List[Tuple]:
        """The stride-2 book onto the next level: per offset k of the
        parent's 2^3 cell, (this level's voxels there, their parents)."""
        c = self.coords % 2
        k = (c[:, 0] * 2 + c[:, 1]) * 2 + c[:, 2]
        rows = torch.arange(self.n, device=self.coords.device)
        return [(rows[k == i], self.parent[k == i]) for i in range(8)]


def _half(size):
    return tuple(-(-s // 2) for s in size)


def levels_of(coords, size) -> List[Level]:
    out = [Level(coords, size)]
    for _ in range(LEVELS - 1):
        out.append(out[-1].coarser())
    return out


def voxelize(cfg: Config, points, feats, valid, point_labels):
    """(level 0, its (n, 3) input features, its (n,) labels) of one
    building's padded points: the voxels of the valid points inside the
    grid, each voxel's features the mean of its points' colours and its
    label the one its points share (-1 otherwise)."""
    size = cfg.voxel_full_scale
    coords = torch.floor(points).to(torch.int64)
    t = torch.tensor(size, device=points.device)
    keep = valid & ((coords >= 0) & (coords < t)).all(1)
    at = _WIDTH * cfg.elements.index("color")
    coords, f = coords[keep], feats[keep][:, at:at + _WIDTH]
    keys, inverse = torch.unique(_keys(coords, size), sorted=True,
                                 return_inverse=True)
    n = keys.shape[0]
    count = torch.zeros(n, device=points.device).index_add_(
        0, inverse, torch.ones_like(f[:, 0]))
    x = torch.zeros((n, _WIDTH), device=points.device).index_add_(
        0, inverse, f) / count[:, None]
    vox = torch.stack([keys // (size[1] * size[2]), (keys // size[2])
                       % size[1], keys % size[2]], 1)
    lab = point_labels[keep].to(torch.int64)
    lo = torch.full((n,), 1 << 40, device=points.device).scatter_reduce(
        0, inverse, lab, "amin")
    hi = torch.full((n,), -(1 << 40), device=points.device).scatter_reduce(
        0, inverse, lab, "amax")
    labels = torch.where((lo == hi) & (lo >= 0), lo, -1)
    return Level(vox, size), x, labels


def plan(level0: Level) -> Dict:
    """The levels and every book a forward reads."""
    lv = levels_of(level0.coords, level0.size)
    return {"levels": lv, "stem": lv[0].cube_book(5),
            "cube": [level.cube_book(3) for level in lv],
            "down": [level.sample_book() for level in lv[:-1]]}


# -- modules ------------------------------------------------------------------

class BookConv(torch.autograd.Function):
    """out[dst] += x[src] @ w[k] for each offset k's pairs (src, dst) of
    the book; the backward gathers again: dx[src] += g[dst] @ w[k]^T and
    dw[k] = x[src]^T g[dst]."""

    @staticmethod
    def forward(ctx, x, w, book, n_out):
        ctx.book = book
        ctx.save_for_backward(x, w)
        out = x.new_zeros((n_out, w.shape[-1]))
        for (src, dst), wk in zip(book, w):
            out.index_add_(0, dst, x[src] @ wk)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w)
        for k, (src, dst) in enumerate(ctx.book):
            gk = g[dst]
            dw[k] = x[src].T @ gk
            if dx is not None:
                dx.index_add_(0, src, gk @ w[k].T)
        return dx, dw, None, None


def book_conv(x, book, w, n_out):
    """sum over offsets k of the rows ``book[k]`` pairs: x[in] @ w[k]
    added into out[out] (:class:`BookConv`)."""
    return BookConv.apply(x, w, book, n_out)


class CubeConv(nn.Module):
    def __init__(self, cin: int, cout: int, volume: int = 27):
        super().__init__()
        self.w = nn.Parameter(torch.empty(volume, cin, cout))

    def forward(self, x, book):
        return book_conv(x, book, self.w, x.shape[0])


class SampleConv(nn.Module):
    """2^3 stride-2 conv over a level's stride-2 book (fine voxels into
    their parents), or (transposed) the same book read backwards
    (parents back onto their fine voxels)."""

    def __init__(self, cin: int, cout: int, transposed: bool = False):
        super().__init__()
        self.transposed = transposed
        self.w = nn.Parameter(torch.empty(8, cin, cout))

    def forward(self, x, book, n_out: int):
        if self.transposed:
            book = [(parent, fine) for fine, parent in book]
        return book_conv(x, book, self.w, n_out)


class BN(nn.Module):
    def __init__(self, c: int, relu: bool, eps: float):
        super().__init__()
        self.relu, self.eps = relu, eps
        self.scale = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        y = F.batch_norm(x, None, None, self.scale, self.bias, training=True,
                         eps=self.eps)
        return torch.relu(y) if self.relu else y


class Linear(nn.Module):
    """A 1^3 conv (``bias``: with its bias)."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, cout))
        if bias:
            self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        y = x @ self.w
        return y + self.bias if hasattr(self, "bias") else y


class BasicBlock(nn.Module):
    def __init__(self, cin: int, c: int, eps: float):
        super().__init__()
        self.conv1, self.bn1 = CubeConv(cin, c), BN(c, True, eps)
        self.conv2, self.bn2 = CubeConv(c, c), BN(c, False, eps)
        if cin != c:
            self.downsample, self.bn_down = Linear(cin, c), BN(c, False, eps)

    def forward(self, x, book):
        y = self.bn2(self.conv2(self.bn1(self.conv1(x, book)), book))
        r = self.bn_down(self.downsample(x)) if hasattr(self, "downsample") \
            else x
        return torch.relu(y + r)


class MinkUNet34C(nn.Module):
    """The reference network on a configuration; ``forward(levels' plan,
    x)`` gives the (n, out_channels) logits of level 0's voxels."""

    def __init__(self, cfg: Config):
        super().__init__()
        eps, planes, layers = BN_EPS, cfg.planes, cfg.layers
        self.conv0p1s1 = CubeConv(_WIDTH, cfg.init_dim, 125)
        self.bn0 = BN(cfg.init_dim, True, eps)
        cin = cfg.init_dim
        for k, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                                  "conv4p8s2")):
            self.add_module(name, SampleConv(cin, cin))
            self.add_module(f"bn{k + 1}", BN(cin, True, eps))
            self.add_module(f"block{k + 1}", nn.ModuleList(
                [BasicBlock(cin if i == 0 else planes[k], planes[k], eps)
                 for i in range(layers[k])]))
            cin = planes[k]
        skips = (planes[2], planes[1], planes[0], cfg.init_dim)
        for j, name in enumerate(("convtr4p16s2", "convtr5p8s2",
                                  "convtr6p4s2", "convtr7p2s2")):
            c = planes[4 + j]
            self.add_module(name, SampleConv(cin, c, transposed=True))
            self.add_module(f"bntr{4 + j}", BN(c, True, eps))
            self.add_module(f"block{5 + j}", nn.ModuleList(
                [BasicBlock(c + skips[j] if i == 0 else c, c, eps)
                 for i in range(layers[4 + j])]))
            cin = c
        self.final = Linear(cin, cfg.out_channels, bias=True)

    def forward(self, p: Dict, x):
        lv, cube = p["levels"], p["cube"]
        h = self.bn0(self.conv0p1s1(x, p["stem"]))
        skips = [h]
        for k, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                                  "conv4p8s2"), 1):
            h = getattr(self, f"bn{k}")(getattr(self, name)(
                h, p["down"][k - 1], lv[k].n))
            for block in getattr(self, f"block{k}"):
                h = block(h, cube[k])
            skips.append(h)
        for j, name in enumerate(("convtr4p16s2", "convtr5p8s2",
                                  "convtr6p4s2", "convtr7p2s2")):
            k = LEVELS - 2 - j
            u = getattr(self, f"bntr{4 + j}")(getattr(self, name)(
                h, p["down"][k], lv[k].n))
            h = torch.cat([u, skips[k]], -1)
            for block in getattr(self, f"block{5 + j}"):
                h = block(h, cube[k])
        return self.final(h)


def segmentation_loss(logits, labels):
    """Mean cross-entropy over the voxels whose label is >= 0."""
    keep = labels >= 0
    if not bool(keep.any()):
        return logits.sum() * 0.0
    return F.cross_entropy(logits[keep], labels[keep])


def step(cfg: Config, model: MinkUNet34C, solver, padded: Dict,
         device) -> float:
    """One gated training step on a padded building with
    ``point_labels``; returns the loss (a host number). ``solver`` is
    reference/solver.Solver (the port's SGD, written out)."""
    b = {k: torch.as_tensor(padded[k]).to(device)
         for k in ("points", "feats", "points_valid", "point_labels")}
    solver.zero_grad()
    level0, x, labels = voxelize(cfg, b["points"], b["feats"],
                                 b["points_valid"], b["point_labels"])
    loss = segmentation_loss(model(plan(level0), x), labels)
    loss.backward()
    flat = [loss.detach().reshape(1)] + [p.grad.reshape(-1)
                                          for p in solver.params
                                          if p.grad is not None]
    solver.apply(torch.isfinite(torch.cat(flat)).all())
    return float(loss.detach())
