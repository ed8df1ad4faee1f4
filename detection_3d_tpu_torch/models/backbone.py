"""Sparse FPN backbone over sorted voxel tables.

Counterpart of detection_3d_tpu/models/backbone.py (reference
SparseConvNet fpn_net.py:13-265):

  * :func:`build_pyramid` makes every per-scale table and rulebook of one
    forward once: the strided/deconv books come as scatters from the
    downsample dedup sort, the 27-offset submanifold book of every scale
    from kernel B, and the BEV books as scatters from the z-collapse sort;
  * every rulebook gets its row order grouped by offset mask, once per
    pyramid: a submanifold book from the masks kernel B writes beside it
    (ops/sparse_conv.masks_row_order), the others from the book
    (ops/sparse_conv.rulebook_row_order); and, when the
    pyramid is built for a training forward, its backward book
    (ops/sparse_conv.BackwardBook: the transposed book, its row order and
    the per-offset entry lists). The three travel as one
    ops/sparse_conv.Book, and every list of books is in level order;
  * a unit of B buildings (ops/sparse.py) builds one pyramid for all of
    them: stacked tables, flat books and row orders, one launch of each
    kernel a book; BN takes each building's own statistics;
  * every sparse conv goes through kernel A (ops/sparse_conv.py) over
    its Book;
  * BN runs on batch statistics (ops/norm.py) fused with (leaky) ReLU.

Module and parameter names follow the Flax modules of the JAX package, so
a Flax parameter tree maps one to one onto this module's state_dict
(utils/convert.py). Parameters are kept in f32 and cast to the feature
dtype at use, as the JAX modules do.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.ops.norm import batch_norm_leaky_relu
from detection_3d_tpu_torch.ops.sparse import (
    SparseTensor, build_sparse_tensor, downsample_with_rulebooks,
    neighbor_match_3x3x3,
)
from detection_3d_tpu_torch.ops.sparse_conv import (
    BackwardBook, Book, make_book, masks_row_order, nin_conv,
    rulebook_entries, rulebook_row_order, sparse_conv,
)


def he_normal_(w: torch.Tensor, gen: torch.Generator):
    """SCN-style fan-in init: std = sqrt(2 / (K * Cin)) for (K, Cin, Cout)
    weights, sqrt(2 / Cin) for (Cin, Cout)."""
    fan_in = w.shape[0] * w.shape[1] if w.ndim == 3 else w.shape[0]
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)


def bev_with_rulebook(table: SparseTensor, capacity: int):
    """BEV (z=0) table + (Z, V_bev) rulebook by scatter: every 3D row's
    BEV row comes from the z=0 dedup sort, and rb[z_i, bev_row_i] = i. A
    unit gives its stacked BEV tables and the flat (Z, B * V_bev) book
    over its B * V rows."""
    t = table.stacked()
    nb, v_in = t.units, t.capacity
    coords = t.coords.clone()
    coords[..., 2] = 0
    X, Y, Z = t.spatial_size
    dev = t.device
    feats = torch.zeros(coords.shape[:-1] + (0,), dtype=t.feats.dtype,
                        device=dev)
    rv = t.row_valid
    bev_t, row_map = build_sparse_tensor(coords, feats, rv, (X, Y, 1),
                                         t.batch_size, capacity,
                                         reduce="sum", return_row_map=True)
    unit = torch.arange(nb, device=dev)[:, None]
    ok = rv & (row_map < capacity)
    z = t.coords[..., 2].to(torch.int64)
    n_out = nb * capacity
    flat = torch.where(ok, z * n_out + row_map + unit * capacity, Z * n_out)
    rb = torch.full((Z * n_out + 1,), nb * v_in, dtype=torch.int32,
                    device=dev)
    rb[flat] = (torch.arange(v_in, device=dev) + unit * v_in).to(torch.int32)
    bev = bev_t if table.batched else bev_t.building(0)
    return bev, rb[:Z * n_out].reshape(Z, n_out)


def pyramid_levels(table0: SparseTensor, kernels, strides, caps,
                   backward: bool = False) -> Dict[str, Any]:
    """Tables and rulebooks of ``len(caps)`` levels, all in level order
    (level 0 = ``table0``; ``kernels[k]`` / ``strides[k]`` / ``caps[k +
    1]`` make level k + 1):

      tables; subm[k] the (27, V_k) book of level k from kernel B, with
      its RowOrder from B's masks; down[k] (K, V_{k+1}) and up[k] (K,
      V_k), the conv and deconv books of downsample k (level k -> k + 1
      and back), as scatters of its dedup sort. Each is a
      :class:`~detection_3d_tpu_torch.ops.sparse_conv.Book`, with its
      BackwardBook when ``backward``.

    A unit's ``table0`` gives its stacked tables and flat books, each
    row order sorting all B * V rows of a book by mask.
    """
    tables = [table0]
    down_rb, up_rb = [], []
    for k in range(1, len(caps)):
        t, crb, drb = downsample_with_rulebooks(
            tables[-1], kernels[k - 1], strides[k - 1], caps[k])
        down_rb.append(crb)
        up_rb.append(drb)
        tables.append(t)
    matched = [neighbor_match_3x3x3(t) for t in tables]
    subm_idx = [idx for idx, _ in matched]
    valid = [t.row_valid.reshape(-1) for t in tables]
    cap = [t.rows for t in tables]
    up_order = [rulebook_row_order(rb, cap[k + 1], valid[k])
                for k, rb in enumerate(up_rb)]
    down_order = [rulebook_row_order(rb, cap[k], valid[k + 1])
                  for k, rb in enumerate(down_rb)]
    subm_order = [masks_row_order(masks) for _, masks in matched]
    subm_bwd = [None] * len(tables)
    down_bwd = up_bwd = [None] * len(down_rb)
    if backward:
        # the transposes come without a scatter where one is known
        # (tests/test_torch_backward_books.py holds each against
        # transpose_rulebook): a submanifold book is its own transpose
        # with the offsets reversed (offset k is the negation of offset
        # K - 1 - k), so dFeats reads it as it is, with its order, and W
        # reversed; a downsample's conv and deconv books, two scatters of
        # one mapping, are each other's, row orders and entries (columns
        # swapped) too.
        subm_bwd = [BackwardBook(rb, subm_order[k],
                                 *rulebook_entries(rb, cap[k], valid[k]),
                                 reversed=True)
                    for k, rb in enumerate(subm_idx)]
        down_bwd, up_bwd = [], []
        for k, rb in enumerate(down_rb):
            entries, starts = rulebook_entries(rb, cap[k], valid[k + 1])
            down_bwd.append(BackwardBook(up_rb[k], up_order[k], entries,
                                         starts))
            up_bwd.append(BackwardBook(rb, down_order[k], entries.flip(1),
                                       starts))
    return {"tables": tables,
            "subm": list(map(Book, subm_idx, subm_order, subm_bwd)),
            "down": list(map(Book, down_rb, down_order, down_bwd)),
            "up": list(map(Book, up_rb, up_order, up_bwd))}


def build_pyramid(table0: SparseTensor, cfg: Config,
                  backward: bool = False) -> Dict[str, Any]:
    """All tables + rulebooks for one forward pass: the
    :func:`pyramid_levels` dict of the config's scales (tables, subm,
    down, up; every book a Book, in level order) and ``bev``: {slot:
    (bev_table, the Book of its (Z, V_bev) book)} for the RPN 2D maps.
    With ``backward`` (a forward whose gradient is wanted) every Book
    holds its BackwardBook (the BEV books' by the transposing scatter).
    """
    s3d = cfg.sparse3d
    n_scales = s3d.num_scales
    caps = cfg.caps.scale_caps(n_scales, base=table0.capacity)
    pyr = pyramid_levels(table0, s3d.kernels, s3d.strides, caps, backward)
    pyr["bev"] = {}
    for slot, i_from_top in enumerate(cfg.rpn.rpn_scales_from_top):
        t3d = pyr["tables"][n_scales - 1 - i_from_top]
        bev_t, rb = bev_with_rulebook(t3d, t3d.capacity)
        pyr["bev"][slot] = (bev_t, make_book(
            rb, t3d.rows, bev_t.row_valid.reshape(-1), backward))
    return pyr


class SubmConv(nn.Module):
    """3^3 submanifold conv (``kernel_volume`` 125: 5^3), bias-free (BN
    supplies the shift)."""

    def __init__(self, cin: int, cout: int, kernel_volume: int = 27):
        super().__init__()
        self.w = nn.Parameter(torch.empty(kernel_volume, cin, cout))

    def reset_parameters(self, gen):
        he_normal_(self.w, gen)

    def forward(self, feats, book, valid):
        return sparse_conv(feats, book, self.w.to(feats.dtype), valid)


class NiN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, cout))

    def reset_parameters(self, gen):
        he_normal_(self.w, gen)

    def forward(self, feats, valid):
        return nin_conv(feats, self.w.to(feats.dtype), valid)


class BNLeakyReLU(nn.Module):
    """Masked batch-statistics BN + leaky ReLU of slope ``leakiness`` (0,
    a plain ReLU, in every detector config; 1, BN alone) at ``eps``;
    statistics summed over ``group``'s ranks when one is given (JAX's
    ``sp_axis``)."""

    def __init__(self, c: int, leakiness: float = 0.0, eps: float = 1e-4):
        super().__init__()
        self.leakiness, self.eps = leakiness, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, feats, valid, group=None):
        return batch_norm_leaky_relu(feats, valid, self.scale, self.bias,
                                     self.leakiness, self.eps,
                                     process_group=group)


class ResidualBlock(nn.Module):
    """(identity | NiN) + BN -> Conv -> BN -> Conv (fpn_net.py:60-69)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.shortcut = NiN(cin, cout) if cin != cout else None
        self.bn1 = BNLeakyReLU(cin)
        self.conv1 = SubmConv(cin, cout)
        self.bn2 = BNLeakyReLU(cout)
        self.conv2 = SubmConv(cout, cout)

    def forward(self, feats, book, valid, group=None):
        sc = feats if self.shortcut is None else self.shortcut(feats, valid)
        h = self.conv1(self.bn1(feats, valid, group), book, valid)
        h = self.conv2(self.bn2(h, valid, group), book, valid)
        return sc + h


class DownLayer(nn.Module):
    """BN-ReLU + strided conv (fpn_net.py:77-84)."""

    def __init__(self, cin: int, cout: int, kernel_volume: int):
        super().__init__()
        self.bn = BNLeakyReLU(cin)
        self.w = nn.Parameter(torch.empty(kernel_volume, cin, cout))

    def reset_parameters(self, gen):
        he_normal_(self.w, gen)

    def forward(self, feats, book, in_valid, out_valid, group=None):
        h = self.bn(feats, in_valid, group)
        return sparse_conv(h, book, self.w.to(h.dtype), out_valid)


class UpLayer(DownLayer):
    """BN-ReLU + deconv (fpn_net.py:86-92): a DownLayer over a deconv
    book."""


class BEVConv(nn.Module):
    """z-collapsing conv: kernel [1, 1, Z], stride 1 (fpn_net.py:55-57)."""

    def __init__(self, cin: int, cout: int, z_size: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(z_size, cin, cout))

    def reset_parameters(self, gen):
        he_normal_(self.w, gen)

    def forward(self, feats, book, out_valid):
        return sparse_conv(feats, book, self.w.to(feats.dtype), out_valid)


def _kernel_volume(k):
    return k[0] * k[1] * k[2]


class SparseFPN(nn.Module):
    """Input subm conv + encoder + FPN decoder + BEV maps.

    forward(table0, pyramid) -> (rpn_maps, roi_maps): lists of
    SparseTensor carrying nplane_map-channel features. Decoder levels
    below the deepest map the RPN and ROI heads read, and BEV convs of
    unselected slots, are not computed (XLA removes them from the JAX
    graph the same way); their parameters still exist.

    A spatial shard's pyramid (parallel/spatial.build_spatial_pyramid)
    also carries ``own_valid`` (the rows this shard owns: the validity
    of every BN, conv output and map) and ``process_group`` (BN
    statistics summed over the shards); its submanifold and deconv Books
    hold the HaloExchange that refreshes their input.
    """

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        s3d = cfg.sparse3d
        n, planes, n_map = s3d.num_scales, s3d.nplanes_front, s3d.nplane_map
        self.conv_in = SubmConv(cfg.in_channels, planes[0])
        for k in range(n):
            if k > 0:
                self.add_module(f"down{k}", DownLayer(
                    planes[k - 1], planes[k],
                    _kernel_volume(s3d.kernels[k - 1])))
            for r in range(s3d.block_reps):
                if s3d.residual_block:
                    self.add_module(f"block{k}_{r}",
                                    ResidualBlock(planes[k], planes[k]))
                else:
                    self.add_module(f"vgg_bn{k}_{r}", BNLeakyReLU(planes[k]))
                    self.add_module(f"vgg_conv{k}_{r}",
                                    SubmConv(planes[k], planes[k]))
        self.add_module(f"shortcut{n - 1}", NiN(planes[-1], n_map))
        for j in range(n - 2, -1, -1):
            self.add_module(f"up{j}", UpLayer(
                n_map, n_map, _kernel_volume(s3d.kernels[j])))
            self.add_module(f"shortcut{j}", NiN(planes[j], n_map))
            self.add_module(f"merge{j}", SubmConv(n_map, n_map))
        sizes = s3d.spatial_sizes()
        for slot, i_from_top in enumerate(cfg.rpn.rpn_scales_from_top):
            z = sizes[n - 1 - i_from_top][2]
            self.add_module(f"pro2d{slot}", BEVConv(n_map, n_map, z))

    def forward(self, table0: SparseTensor, pyramid: Dict[str, Any]):
        cfg = self.cfg
        s3d = cfg.sparse3d
        n = s3d.num_scales
        tables: List[SparseTensor] = pyramid["tables"]
        subm, down, up = pyramid["subm"], pyramid["down"], pyramid["up"]
        # a spatial shard's pyramid: own rows, BN group
        valids = pyramid.get("own_valid") or [t.row_valid for t in tables]
        group = pyramid.get("process_group")
        n3d = len(cfg.rpn.rpn_scales_from_top)
        sel = cfg.rpn.rpn_3d_2d_selector
        # feature maps (counted from the top) that some head reads
        used = {cfg.rpn.rpn_scales_from_top[i % n3d] for i in sel}
        used |= set(cfg.roi.pooler_scales_from_top)

        h = self.conv_in(table0.feats, subm[0], valids[0])
        downs = []
        for k in range(n):
            if k > 0:
                h = getattr(self, f"down{k}")(h, down[k - 1], valids[k - 1],
                                              valids[k], group)
            for r in range(s3d.block_reps):
                if s3d.residual_block:
                    h = getattr(self, f"block{k}_{r}")(h, subm[k], valids[k],
                                                       group)
                else:
                    hh = getattr(self, f"vgg_bn{k}_{r}")(h, valids[k], group)
                    h = getattr(self, f"vgg_conv{k}_{r}")(hh, subm[k],
                                                          valids[k])
            downs.append(h)

        net = getattr(self, f"shortcut{n - 1}")(downs[-1], valids[-1])
        ups = [net]      # ups[i] = features at scale n-1-i
        # up[j] maps level j + 1 onto j; none below the deepest map read
        for j in range(n - 2, n - 2 - min(max(used), n - 1), -1):
            net = getattr(self, f"up{j}")(net, up[j], valids[j + 1],
                                          valids[j], group)
            net = net + getattr(self, f"shortcut{j}")(downs[j], valids[j])
            net = getattr(self, f"merge{j}")(net, subm[j], valids[j])
            ups.append(net)

        maps = {}
        for i in sel:
            slot = i % n3d
            i_from_top = cfg.rpn.rpn_scales_from_top[slot]
            t3d = tables[n - 1 - i_from_top]
            if i < n3d:
                maps[i] = t3d.with_feats(ups[i_from_top])
            else:
                bev_t, bev_book = pyramid["bev"][slot]
                f2d = getattr(self, f"pro2d{slot}")(
                    ups[i_from_top], bev_book, bev_t.row_valid)
                maps[i] = bev_t.with_feats(f2d)
        rpn_maps = [maps[i] for i in sel]
        roi_maps = [tables[n - 1 - i].with_feats(ups[i])
                    for i in cfg.roi.pooler_scales_from_top]
        return rpn_maps, roi_maps
