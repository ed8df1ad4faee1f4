"""Spatial sharding of one building over ranks: x-slabs with halo exchange.

Counterpart of detection_3d_tpu/parallel/spatial.py over
``torch.distributed`` (one process per shard; the shards of a building
form one process group, a mesh's ``sp`` axis). For a building whose
voxel set one card cannot hold:

  * shard d owns x in [d * w_s, (d + 1) * w_s) at scale s (w_s = X_s / D;
    the slabs stay aligned across scales because X is divisible by D
    times the product of the strides);
  * at each scale the shard's own table is EXTENDED with one halo column
    from each neighbour (x = slab_lo - 1 and slab_hi + 1), enough for the
    3^3 submanifold convs and the deconvs: the columns' coords are
    exchanged once per scale (:func:`_extend_with_halo`);
  * before every conv whose book carries a :class:`HaloExchange` (every
    submanifold book and every deconv book), the input's halo rows are
    refreshed from the neighbours' boundary rows; its backward sends
    the halo rows' gradients back and adds them into the owners'
    boundary rows. Rows are key-sorted, so a boundary column and the
    matching halo column list their sites in the same (y, z) order and
    the payload needs no matching;
  * BN statistics are summed over the shards, and every BN, conv output
    and map counts the OWN rows only (halo rows are copies);
  * the pyramid's books come from the kernels: each scale's submanifold
    book from kernel B, the strided and deconv books from kernel D
    (an extended table at scale k is not the downsample of the one at
    k - 1, so the scatter-derived books of models/backbone.build_pyramid
    do not apply), the BEV books by scatter, kernel A's row order of
    every book over own output rows, and with ``backward`` every
    BackwardBook by the transposing scatter (the single-device pyramid's
    shortcut, a submanifold book read with its offsets reversed, does
    not hold where input rows are halo rows that are no conv's output);
  * owned map rows are all-gathered into the global maps, and the small
    RPN and ROI heads run replicated on them with the same draws on
    every shard.

Gradients: each shard's loss is the heads' loss divided by the number of
shards; the backward of the all-gather sums the map cotangents over the
shards, BN's sums and the halo refresh route theirs, and ONE all-reduce
of every parameter's gradient after the backward gives the exact global
gradient (JAX gets it from shard_map's varying-axis transpose). A halo
column with more sites than its cap drops them and sets the overflow
flag, which every entry point returns (reduced over the ranks).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Sequence

import torch
import torch.distributed as dist

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.engine.trainer import total_loss
from detection_3d_tpu_torch.models.backbone import bev_with_rulebook
from detection_3d_tpu_torch.models.detector import voxelize_points
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.ops.multi_match import (
    conv_rulebook_match, deconv_rulebook_match)
from detection_3d_tpu_torch.ops.sparse import (
    SparseTensor, build_sparse_tensor, downsample_table, neighbor_match_3x3x3)
from detection_3d_tpu_torch.ops.sparse_conv import (
    backward_book, masks_row_order, rulebook_row_order)
from detection_3d_tpu_torch.parallel.collectives import (
    _gather, all_gather_rows, group_rank, group_size)
from detection_3d_tpu_torch.parallel.mesh import Mesh, reduce_step

_LOG = logging.getLogger(__name__)


def warn_halo_overflow(overflow, where: str) -> bool:
    """Log and return whether a halo column exceeded its cap (its
    boundary rows were dropped and slab-edge convs are wrong)."""
    if bool(overflow):
        _LOG.warning(
            "%s: a halo column exceeded halo_caps on at least one shard — "
            "boundary rows were DROPPED and slab-edge convolutions are "
            "wrong; raise halo_caps", where)
        return True
    return False


def _compact(mask, cap: int):
    """Positions of the first ``cap`` true rows of ``mask``, in row
    order: (idx (cap,) int64, ok (cap,) bool); slot i holds a real row
    where ok[i], else the last row."""
    n = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, cap)
    idx = torch.full((cap + 1,), n - 1, dtype=torch.int64, device=dev)
    idx[slot] = torch.arange(n, device=dev)    # slot cap takes the rest
    ok = torch.arange(cap, device=dev) < torch.clamp(mask.sum(), max=cap)
    return idx[:cap], ok


def _neighbours(parts: List[torch.Tensor], group):
    """(left, right): the payloads of ranks r - 1 and r + 1, zeros at the
    ends of the line."""
    r, d = group_rank(group), group_size(group)
    zero = torch.zeros_like(parts[0])
    return (parts[r - 1] if r > 0 else zero,
            parts[r + 1] if r + 1 < d else zero)


def _rows(feats, idx, ok):
    return torch.where(ok[:, None], feats[idx], 0)


def _padded(feats):
    return torch.cat([feats, feats.new_zeros((1,) + feats.shape[1:])])


def _put(feats, idx, ok, rows):
    """``feats`` with the rows at ``idx`` (where ok) replaced by ``rows``."""
    n = feats.shape[0]
    out = _padded(feats)
    out[torch.where(ok, idx, n)] = rows
    return out[:n]


def _add(feats, idx, ok, rows):
    """``feats`` with ``rows`` added at ``idx`` (where ok)."""
    n = feats.shape[0]
    return _padded(feats).index_add_(0, torch.where(ok, idx, n),
                                     rows.to(feats.dtype))[:n]


class _HaloRefresh(torch.autograd.Function):
    """Forward: every shard's lo-edge rows become its left neighbour's hi
    halo rows and its hi-edge rows its right neighbour's lo halo rows
    (one all-gather of both payloads). Backward: the gradient at the
    halo rows goes back to the owners and is added into their edge rows;
    locally it is zero there, since the forward overwrote those rows."""

    @staticmethod
    def forward(ctx, feats, halo):
        ctx.halo = halo
        h = halo
        payload = torch.stack([_rows(feats, h.send_lo, h.send_lo_ok),
                               _rows(feats, h.send_hi, h.send_hi_ok)])
        left, right = _neighbours(_gather(payload, h.group), h.group)
        out = _put(feats, h.recv_lo, h.recv_lo_ok, left[1])
        return _put(out, h.recv_hi, h.recv_hi_ok, right[0])

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        payload = torch.stack([_rows(g, h.recv_lo, h.recv_lo_ok),
                               _rows(g, h.recv_hi, h.recv_hi_ok)])
        left, right = _neighbours(_gather(payload, h.group), h.group)
        zero = torch.zeros_like(payload[0])
        gf = _put(_put(g, h.recv_lo, h.recv_lo_ok, zero), h.recv_hi,
                  h.recv_hi_ok, zero)
        # my lo-edge rows fed the left neighbour's hi halo, my hi-edge
        # rows the right neighbour's lo halo
        gf = _add(gf, h.send_lo, h.send_lo_ok, left[1])
        return _add(gf, h.send_hi, h.send_hi_ok, right[0]), None


class HaloExchange:
    """One scale's feature refresh across the shards of ``group``: the
    rows of this shard's extended table at x == slab_lo / slab_hi
    (``send_*``, sent to the left / right neighbour) and at x == slab_lo
    - 1 / slab_hi + 1 (``recv_*``, written from them), each (cap,) int64
    with its (cap,) bool ``_ok``."""

    def __init__(self, group, send_lo, send_lo_ok, send_hi, send_hi_ok,
                 recv_lo, recv_lo_ok, recv_hi, recv_hi_ok):
        self.group = group
        self.send_lo, self.send_lo_ok = send_lo, send_lo_ok
        self.send_hi, self.send_hi_ok = send_hi, send_hi_ok
        self.recv_lo, self.recv_lo_ok = recv_lo, recv_lo_ok
        self.recv_hi, self.recv_hi_ok = recv_hi, recv_hi_ok

    def refresh(self, feats):
        """``feats`` (V_ext, C) with its halo rows set to the neighbours'
        edge rows; differentiable."""
        return _HaloRefresh.apply(feats, self)


def _extend_with_halo(own: SparseTensor, slab_lo: int, slab_hi: int,
                      halo_cap: int, group):
    """Exchange the boundary columns' coords and build the extended
    table (own rows + one halo column from each neighbour).

    Returns (ext_table, own_mask, HaloExchange, overflow: a bool tensor,
    true when a boundary column that a neighbour receives holds more
    than ``halo_cap`` sites; the grid's outer faces count for none)."""
    x = own.coords[:, 0]
    ov = own.row_valid
    lo_mask = ov & (x == slab_lo)
    hi_mask = ov & (x == slab_hi)
    r, n_shards = group_rank(group), group_size(group)
    overflow = torch.maximum(lo_mask.sum() * (r > 0),
                             hi_mask.sum() * (r + 1 < n_shards)) > halo_cap
    sl_idx, sl_ok = _compact(lo_mask, halo_cap)
    sh_idx, sh_ok = _compact(hi_mask, halo_cap)
    cl = torch.where(sl_ok[:, None], own.coords[sl_idx], -1)
    ch = torch.where(sh_ok[:, None], own.coords[sh_idx], -1)
    payload = torch.cat([cl, sl_ok[:, None].to(torch.int32), ch,
                         sh_ok[:, None].to(torch.int32)], 1)
    left, right = _neighbours(_gather(payload, group), group)
    # my lo halo is the left neighbour's hi column, my hi halo the right
    # neighbour's lo column
    coords = torch.cat([own.coords, left[:, 5:9], right[:, 0:4]], 0)
    valid = torch.cat([ov, left[:, 9] > 0, right[:, 4] > 0], 0)
    nch = own.feats.shape[-1]
    feats = torch.cat([own.feats, own.feats.new_zeros((2 * halo_cap, nch))])
    ext = build_sparse_tensor(coords, feats, valid, own.spatial_size,
                              own.batch_size, own.capacity + 2 * halo_cap,
                              reduce="sum")
    ex = ext.coords[:, 0]
    ev = ext.row_valid
    own_mask = ev & (ex >= slab_lo) & (ex <= slab_hi)
    halo = HaloExchange(group,
                        *_compact(ev & (ex == slab_lo), halo_cap),
                        *_compact(ev & (ex == slab_hi), halo_cap),
                        *_compact(ev & (ex == slab_lo - 1), halo_cap),
                        *_compact(ev & (ex == slab_hi + 1), halo_cap))
    return ext, own_mask, halo, overflow


def _own_only(table: SparseTensor, own_mask) -> SparseTensor:
    """A view whose rows outside ``own_mask`` carry out-of-grid coords, so
    no downsample candidate or BEV column comes from them."""
    coords = torch.where(own_mask[:, None], table.coords, -1)
    return SparseTensor(coords, table.feats, table.hi, table.lo, table.num,
                        table.spatial_size, table.batch_size, table.true_num,
                        table.keys)


def _check_divisible(cfg: Config, n_shards: int):
    """Raise unless X is divisible by n_shards times the strides'
    product along x (the slabs must stay aligned across scales)."""
    s3d = cfg.sparse3d
    step = n_shards
    for st in s3d.strides:
        step *= st[0]
    if s3d.voxel_full_scale[0] % step:
        raise ValueError(
            f"spatial sharding: X = {s3d.voxel_full_scale[0]} is not "
            f"divisible by {n_shards} shards x the x-strides ({step})")


def build_spatial_pyramid(cfg: Config, points, feats, points_valid, group,
                          shard_caps: Sequence[int],
                          halo_caps: Sequence[int],
                          backward: bool = False) -> Dict[str, Any]:
    """This shard's pyramid over extended (own + halo) tables, in the
    layout of models/backbone.build_pyramid (tables, subm_idx, down_rb,
    up_rb, bev and their row orders; with ``backward`` the BackwardBooks)
    plus ``own_valid`` (per scale), ``subm_halo`` (per scale),
    ``up_halo`` (decoder order), ``process_group`` and
    ``halo_overflow``.

    Every shard gets the whole (padded) point cloud and voxelizes the
    points of its x-slab into a table of ``shard_caps[0]`` rows;
    ``shard_caps[s]`` bounds its own rows at scale s and
    ``halo_caps[s]`` one boundary column (Y_s * Z_s is exact)."""
    s3d = cfg.sparse3d
    n = s3d.num_scales
    d, n_shards = group_rank(group), group_size(group)
    _check_divisible(cfg, n_shards)
    w0 = s3d.voxel_full_scale[0] // n_shards
    vox_x = torch.floor(points[:, 0]).to(torch.int32)
    in_slab = (vox_x >= d * w0) & (vox_x < (d + 1) * w0)
    own = voxelize_points(cfg, points, feats, points_valid & in_slab,
                          capacity=shard_caps[0])
    tables, own_valid, halos = [], [], []
    overflow = torch.zeros((), dtype=torch.bool, device=points.device)
    for s in range(n):
        w_s = own.spatial_size[0] // n_shards
        ext, own_m, halo, ovf = _extend_with_halo(
            own, d * w_s, (d + 1) * w_s - 1, halo_caps[s], group)
        overflow = overflow | ovf
        tables.append(ext)
        own_valid.append(own_m)
        halos.append(halo)
        if s + 1 < n:
            own = downsample_table(_own_only(ext, own_m), s3d.kernels[s],
                                   s3d.strides[s], shard_caps[s + 1])

    cap = [t.capacity for t in tables]
    matched = [neighbor_match_3x3x3(t) for t in tables]       # kernel B
    subm_idx = [idx for idx, _ in matched]
    subm_order = [masks_row_order(torch.where(own_m, masks, 0))
                  for (_, masks), own_m in zip(matched, own_valid)]
    # strided books: kernel D; their gathers stay inside the own slab
    down_rb = [conv_rulebook_match(tables[k], tables[k - 1],
                                   s3d.kernels[k - 1], s3d.strides[k - 1])
               for k in range(1, n)]
    down_order = [rulebook_row_order(rb, cap[k], own_valid[k + 1])
                  for k, rb in enumerate(down_rb)]
    # deconv books (decoder order): kernel D; they read the coarse halo
    ks = list(range(n - 1, 0, -1))
    up_rb = [deconv_rulebook_match(tables[k - 1], tables[k],
                                   s3d.kernels[k - 1], s3d.strides[k - 1])
             for k in ks]
    up_order = [rulebook_row_order(rb, cap[k], own_valid[k - 1])
                for k, rb in zip(ks, up_rb)]
    bev, bev_order, bev_v_in = {}, {}, {}
    for slot, i_from_top in enumerate(cfg.rpn.rpn_scales_from_top):
        sc = n - 1 - i_from_top
        bev[slot] = bev_with_rulebook(_own_only(tables[sc], own_valid[sc]),
                                      cap[sc])
        bev_v_in[slot] = cap[sc]
        bev_order[slot] = rulebook_row_order(bev[slot][1], cap[sc],
                                             bev[slot][0].row_valid)
    pyr = {"tables": tables, "subm_idx": subm_idx, "down_rb": down_rb,
           "up_rb": up_rb, "bev": bev, "subm_order": subm_order,
           "down_order": down_order, "up_order": up_order,
           "bev_order": bev_order, "own_valid": own_valid,
           "subm_halo": halos, "up_halo": [halos[k] for k in ks],
           "process_group": group, "halo_overflow": overflow}
    if backward:
        pyr.update(
            subm_bwd=[backward_book(rb, cap[k], own_valid[k])
                      for k, rb in enumerate(subm_idx)],
            down_bwd=[backward_book(rb, cap[k], own_valid[k + 1])
                      for k, rb in enumerate(down_rb)],
            up_bwd=[backward_book(rb, cap[k], own_valid[k - 1])
                    for k, rb in zip(ks, up_rb)],
            bev_bwd={slot: backward_book(rb, bev_v_in[slot], t.row_valid)
                     for slot, (t, rb) in bev.items()})
    return pyr


def any_over(flag, group):
    """A bool tensor: ``flag`` on any rank of ``group``."""
    v = flag.to(torch.int32).reshape(1)
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
    return v[0] > 0


def spatial_fpn_apply(cfg: Config, mesh: Mesh, fpn, points, feats,
                      points_valid, shard_caps, halo_caps):
    """The SparseFPN trunk ``fpn`` (models/backbone.SparseFPN) spatially
    sharded over ``mesh``'s ``sp`` axis: every shard passes the whole
    point cloud. Returns this shard's (rpn_maps, roi_maps, own_valid,
    overflow): its maps over its extended tables, whose own rows equal
    the single-device maps' rows of the same coords, and the overflow
    flag of every shard (also logged)."""
    group = mesh.group("sp")
    pyr = build_spatial_pyramid(cfg, points, feats, points_valid, group,
                                shard_caps, halo_caps)
    rpn_maps, roi_maps = fpn(pyr["tables"][0], pyr)
    overflow = any_over(pyr["halo_overflow"], group)
    warn_halo_overflow(overflow, "spatial_fpn_apply")
    return rpn_maps, roi_maps, pyr["own_valid"], overflow


def _gather_global_map(t: SparseTensor, own_mask, group,
                       cap_out: int) -> SparseTensor:
    """The OWNED rows of every shard's map ``t`` all-gathered into one
    global table (the same on every shard); differentiable in the
    features."""
    idx, ok = _compact(own_mask, t.capacity)
    head = torch.cat([torch.where(ok[:, None], t.coords[idx], -1),
                      ok[:, None].to(torch.int32)], 1)
    head_all = all_gather_rows(head, group)
    feats_all = all_gather_rows(torch.where(ok[:, None], t.feats[idx], 0),
                                group)
    return build_sparse_tensor(head_all[:, :4], feats_all, head_all[:, 4] > 0,
                               t.spatial_size, t.batch_size, cap_out,
                               reduce="sum")


def _gather_global_maps(cfg: Config, spyr, rpn_maps, roi_maps, group):
    """Every RPN and ROI map of the shards as a global map, at the
    single-device pyramid's capacity of its scale."""
    n = cfg.sparse3d.num_scales
    caps = cfg.caps.scale_caps(n)
    n3d = len(cfg.rpn.rpn_scales_from_top)
    global_rpn = []
    for slot, m in enumerate(rpn_maps):
        sel = cfg.rpn.rpn_3d_2d_selector[slot]
        sc = n - 1 - cfg.rpn.rpn_scales_from_top[sel % n3d]
        # a 3D map's own rows; a BEV map's table holds own columns only
        own = spyr["own_valid"][sc] if sel < n3d else m.row_valid
        global_rpn.append(_gather_global_map(m, own, group, caps[sc]))
    global_roi = []
    for i, i_from_top in enumerate(cfg.roi.pooler_scales_from_top):
        sc = n - 1 - i_from_top
        global_roi.append(_gather_global_map(
            roi_maps[i], spyr["own_valid"][sc], group, caps[sc]))
    return global_rpn, global_roi


def spatial_maps(cfg: Config, model, batch, group, shard_caps, halo_caps,
                 backward: bool = False):
    """(global_rpn, global_roi, pyramid): the sharded trunk of ``model``
    (a SparseRCNN) on a padded building (pad_scene dict, numpy or
    tensors), its owned rows all-gathered into the global maps."""
    dev = next(model.parameters()).device
    pts, fts, valid = (torch.as_tensor(batch[k]).to(dev)
                       for k in ("points", "feats", "points_valid"))
    spyr = build_spatial_pyramid(cfg, pts, fts, valid, group, shard_caps,
                                 halo_caps, backward)
    table0 = spyr["tables"][0]
    table0 = table0.with_feats(
        table0.feats.to(getattr(torch, cfg.compute_dtype)))
    rpn_maps, roi_maps = model.backbone(table0, spyr)
    global_rpn, global_roi = _gather_global_maps(cfg, spyr, rpn_maps,
                                                 roi_maps, group)
    return global_rpn, global_roi, spyr


@torch.no_grad()
def spatial_predict(cfg: Config, mesh: Mesh, model, batch, shard_caps,
                    halo_caps):
    """Sharded inference of one padded building: the trunk runs sharded
    with halo exchange, the heads replicated on the gathered global
    maps, so every shard holds the same detections. Returns (detections
    as a Boxes3D with fields scores and labels, overflow flag)."""
    group = mesh.group("sp")
    global_rpn, global_roi, spyr = spatial_maps(cfg, model, batch, group,
                                                shard_caps, halo_caps)
    det = model.heads(global_rpn, global_roi)
    overflow = any_over(spyr["halo_overflow"], group)
    warn_halo_overflow(overflow, "spatial_predict")
    return det, overflow


def _sharded_backward(cfg: Config, model, batch, group, shard_caps,
                      halo_caps, scale: float, generator, priorities):
    """The sharded training forward of one building and the backward of
    its loss times ``scale``, gradients left unreduced on the
    parameters. Returns (total, losses, this shard's overflow)."""
    dev = next(model.parameters()).device
    global_rpn, global_roi, spyr = spatial_maps(cfg, model, batch, group,
                                                shard_caps, halo_caps,
                                                backward=True)
    gt = Boxes3D(torch.as_tensor(batch["gt_boxes"]).to(dev),
                 torch.as_tensor(batch["gt_valid"]).to(dev))
    gt_labels = torch.as_tensor(batch["gt_labels"]).to(dev)
    if priorities is None:
        priorities = {k: torch.rand((m,), generator=generator, device=dev)
                      for k, m in model.priority_shapes().items()}
    out = model.heads(global_rpn, global_roi, gt, gt_labels,
                      priorities=priorities)
    losses = out[0] if cfg.eval_in_train else out
    total = total_loss(losses)
    (total * scale).backward()
    return total.detach(), {k: v.detach() for k, v in losses.items()}, \
        spyr["halo_overflow"]


def make_dp_spatial_grad_fn(cfg: Config, mesh: Mesh, model, shard_caps,
                            halo_caps):
    """Loss and exact mean-over-buildings gradient of the spatially
    sharded model on a (dp, sp) mesh (parallel/mesh.make_mesh_2d) or a
    1-D ``sp`` mesh (one dp group): dp group d takes building d of
    ``batches`` (one padded building per dp group, the same list on
    every rank), sharded over its sp ranks; each rank's loss is divided
    by n_sp * n_dp (the all-gather's backward sums the map cotangents
    over the shards) and ONE all-reduce over every rank sums the
    gradients.

    Returns ``grad_fn(batches, generator=None, priorities=None) ->
    (total, losses, ok, overflow)``: the means over the buildings, the
    NaN gate over the reduced gradient and the overflow flag, tensors
    alike on every rank; afterwards every parameter's ``.grad`` holds
    the global gradient. ``priorities`` is one draw dict per building,
    ``generator`` this dp group's (parallel/mesh.rank_generator), seeded
    alike on its shards."""
    sp_group, n_sp = mesh.group("sp"), mesh.size("sp")
    n_dp, d = ((mesh.size("dp"), mesh.coord("dp")) if "dp" in mesh.axes
               else (1, 0))
    params = list(model.parameters())

    def grad_fn(batches, generator=None, priorities=None):
        if len(batches) != n_dp:
            raise ValueError(f"spatial grad_fn: {len(batches)} buildings "
                             f"for {n_dp} dp groups")
        for p in params:
            p.grad = None
        scale = 1.0 / (n_sp * n_dp)
        total, losses, ovf = _sharded_backward(
            cfg, model, batches[d], sp_group, shard_caps, halo_caps, scale,
            generator, None if priorities is None else priorities[d])
        names = sorted(losses)
        stats = torch.cat([torch.stack([total] + [losses[k] for k in names])
                           * scale, ovf.to(torch.float32).reshape(1)])
        reduced, ok = reduce_step(params, stats, None)
        return (reduced[0], dict(zip(names, reduced[1:-1])), ok,
                reduced[-1] > 0)

    return grad_fn


def make_spatial_grad_fn(cfg: Config, mesh: Mesh, model, shard_caps,
                         halo_caps):
    """:func:`make_dp_spatial_grad_fn` on one building: ``grad_fn(batch,
    generator=None, priorities=None) -> (total, losses, ok,
    overflow)``."""
    grad_fn = make_dp_spatial_grad_fn(cfg, mesh, model, shard_caps,
                                      halo_caps)

    def one(batch, generator=None, priorities=None):
        return grad_fn([batch], generator,
                       None if priorities is None else [priorities])

    return one


def _committing(grad_fn, solver):
    """``grad_fn``, then the solver's update committed only where ``ok``
    (alike on every rank)."""

    def step(batches, generator=None, priorities=None):
        total, losses, ok, overflow = grad_fn(batches, generator,
                                              priorities)
        solver.apply(ok)
        return total, losses, ok, overflow

    return step


def make_spatial_train_step(cfg: Config, mesh: Mesh, model, solver,
                            shard_caps, halo_caps):
    """The spatially sharded training step of one building:
    ``step(batch, generator=None, priorities=None) -> (total, losses, ok,
    overflow)``."""
    return _committing(make_spatial_grad_fn(cfg, mesh, model, shard_caps,
                                            halo_caps), solver)


def make_dp_spatial_train_step(cfg: Config, mesh: Mesh, model, solver,
                               shard_caps, halo_caps):
    """The (dp, sp) training step: ``step(batches, generator=None,
    priorities=None) -> (total, losses, ok, overflow)``."""
    return _committing(make_dp_spatial_grad_fn(cfg, mesh, model, shard_caps,
                                               halo_caps), solver)
