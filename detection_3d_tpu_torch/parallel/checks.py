"""Rank functions that drive the multi-device entry points on given
inputs and return host results (numpy), for parallel/mesh.launch.

The parity tests (tests/test_torch_parallel_mesh.py,
tests/test_torch_spatial.py) and chip_smoke.py start them in spawned
rank processes, which import them by name; so they live here, in the
package, and import nothing but it. Weights arrive as a state dict of
numpy arrays, buildings as padded pad_scene dicts, and the samplers'
draws, where given, as dicts of numpy arrays (one per building).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.parallel.collectives import (
    all_gather_rows, all_reduce_sum, group_rank, shift)
from detection_3d_tpu_torch.parallel.mesh import (
    batched_train_step, make_mesh, make_mesh_2d)


def rank_input(seed: int, rank: int, shape=(3, 4)) -> np.ndarray:
    """The deterministic payload of ``rank`` in :func:`collectives_job`
    (and its cotangent with ``seed + 1``)."""
    return np.random.RandomState(seed * 100 + rank).randn(*shape).astype(
        np.float32)


def collectives_job(seed: int, device="cpu") -> Dict[str, np.ndarray]:
    """Forward and backward of every differentiable collective on this
    rank's :func:`rank_input`: for each of all_reduce_sum,
    all_gather_rows, shift(+1) and shift(-1) its output and the
    gradient of sum(output * cotangent), the cotangent rank_input(seed
    + 1, rank) of the output's shape (tiled over rows)."""
    mesh = make_mesh(axis="dp", device=device)
    r = group_rank()
    out = {}
    for name, fn in (("all_reduce_sum", all_reduce_sum),
                     ("all_gather_rows", all_gather_rows),
                     ("shift+1", lambda t: shift(t, 1)),
                     ("shift-1", lambda t: shift(t, -1))):
        x = torch.tensor(rank_input(seed, r), device=mesh.device,
                         requires_grad=True)
        y = fn(x)
        ct = torch.tensor(rank_input(seed + 1, r), device=mesh.device)
        ct = ct.repeat(y.shape[0] // ct.shape[0], 1)
        (y * ct).sum().backward()
        out[name] = y.detach()
        out[name + ".grad"] = x.grad
    # bf16 and bool payloads through the gather
    out["bf16"] = all_gather_rows(torch.tensor(
        rank_input(seed, r), device=mesh.device).to(torch.bfloat16))
    out["bool"] = all_gather_rows(torch.tensor(
        rank_input(seed, r) > 0, device=mesh.device))
    return out


def _model(cfg: Config, state: Dict[str, np.ndarray], device):
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    model = SparseRCNN(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model.to(device).train()


def _draws(priorities, device):
    if priorities is None:
        return None
    return {k: torch.as_tensor(v).to(device) for k, v in priorities.items()}


def grads(model) -> Dict[str, torch.Tensor]:
    """A copy of every parameter's gradient (zeros where it has none: a
    reduced data-parallel or spatial gradient gives zeros to the
    parameters the forward did not use)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().clone() for n, p in model.named_parameters()}


def _params(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach() for n, p in model.named_parameters()}


def dp_step_job(cfg: Config, state: Dict[str, np.ndarray],
                batches: Sequence[Dict], priorities: Optional[Sequence],
                device="cpu") -> Dict:
    """One data-parallel step (parallel/mesh.batched_train_step) over
    ``batches`` (the whole step's buildings; rank r takes the r-th run)
    from ``state``. Returns total, losses, ok, true_num, the reduced
    gradients and the parameters after the update."""
    from detection_3d_tpu_torch.engine.solver import Solver
    mesh = make_mesh(axis="dp", device=device)
    model = _model(cfg, state, mesh.device)
    solver = Solver(cfg, model, 1)
    lb = len(batches) // mesh.world_size
    mine = slice(mesh.rank * lb, (mesh.rank + 1) * lb)
    step = batched_train_step(cfg, model, solver, mesh)
    pri = None if priorities is None else \
        [_draws(p, mesh.device) for p in priorities[mine]]
    total, losses, ok, tn, _ = step(list(batches[mine]), None, pri)
    return {"total": total, "losses": losses, "ok": ok, "true_num": tn,
            "grads": grads(model), "params": _params(model)}


def trainer_job(cfg: Config, scenes: List[Dict], output_dir: str,
                epochs: int = 1, device="cpu") -> Dict:
    """``Trainer(mesh=...).train`` over ``scenes`` for ``epochs`` from
    seed-0 weights. Returns the history's (total, ok) rows, the step
    count, the parameters after and, with ``cfg.eval_in_train``, the gt
    counts of the last train-time evaluation."""
    from detection_3d_tpu_torch.engine.trainer import Trainer
    mesh = make_mesh(axis="dp", device=device)
    trainer = Trainer(cfg, output_dir=output_dir, mesh=mesh)
    state = trainer.init_state(seed=0, iters_per_epoch=max(
        -(-len(scenes) // trainer.batch_size()), 1))
    state = trainer.train(scenes, state, epochs=epochs)
    ev = trainer.last_train_eval
    return {"history": [(t, ok) for t, _, ok, _ in trainer.history],
            "step": state.step, "params": _params(state.model),
            "n_gt": None if ev is None else ev.n_gt}


def _own_rows(t, own) -> Dict[str, np.ndarray]:
    own = own.cpu().numpy()
    return {"coords": t.coords.cpu().numpy()[own],
            "feats": t.feats.float().cpu().numpy()[own]}


def detections(det) -> Dict[str, np.ndarray]:
    """The valid rows of a Boxes3D of detections as {boxes, scores,
    labels} numpy arrays."""
    from detection_3d_tpu_torch.engine.trainer import (
        pack_detections, unpack_detections)
    return unpack_detections(pack_detections(det).cpu().numpy())


def spatial_job(cfg: Config, state: Dict[str, np.ndarray], batch: Dict,
                priorities: Optional[Dict], shard_caps, halo_caps,
                small_halo_caps, device="cpu") -> Dict:
    """On a 1-D ``sp`` mesh of every rank, for one padded building:
    the owned rows of every RPN and ROI map (spatial_fpn_apply), the
    detections (spatial_predict), the loss and global gradient
    (make_spatial_grad_fn, with ``priorities``), the overflow flag under
    ``small_halo_caps``, and one training step (make_spatial_train_step)
    with its parameters after."""
    from detection_3d_tpu_torch.engine.solver import Solver
    from detection_3d_tpu_torch.parallel.spatial import (
        make_spatial_grad_fn, make_spatial_train_step, spatial_fpn_apply,
        spatial_predict)
    mesh = make_mesh(axis="sp", device=device)
    model = _model(cfg, state, mesh.device)
    dev = mesh.device
    pts, fts, valid = (torch.as_tensor(batch[k]).to(dev)
                       for k in ("points", "feats", "points_valid"))
    with torch.no_grad():
        rpn, roi, own, ovf = spatial_fpn_apply(
            cfg, mesh, model.backbone, pts, fts, valid, shard_caps,
            halo_caps)
        n = cfg.sparse3d.num_scales
        roi_rows = [_own_rows(m, own[n - 1 - i]) for m, i in
                    zip(roi, cfg.roi.pooler_scales_from_top)]
        n3d = len(cfg.rpn.rpn_scales_from_top)
        rpn_rows = []
        for m, sel in zip(rpn, cfg.rpn.rpn_3d_2d_selector):
            sc = n - 1 - cfg.rpn.rpn_scales_from_top[sel % n3d]
            # a BEV map's table holds this shard's columns only
            rpn_rows.append(_own_rows(m, own[sc] if sel < n3d
                                      else m.row_valid))
        _, _, _, small_ovf = spatial_fpn_apply(
            cfg, mesh, model.backbone, pts, fts, valid, shard_caps,
            small_halo_caps)
    det, pred_ovf = spatial_predict(cfg, mesh, model, batch, shard_caps,
                                    halo_caps)
    pri = _draws(priorities, dev)
    total, losses, ok, grad_ovf = make_spatial_grad_fn(
        cfg, mesh, model, shard_caps, halo_caps)(batch, priorities=pri)
    got = grads(model)
    solver = Solver(cfg, model, 1)
    step = make_spatial_train_step(cfg, mesh, model, solver, shard_caps,
                                   halo_caps)
    _, _, step_ok, _ = step(batch, priorities=pri)
    return {"roi_rows": roi_rows, "rpn_rows": rpn_rows,
            "overflow": [ovf, pred_ovf, grad_ovf],
            "small_overflow": small_ovf, "det": detections(det), "total": total,
            "losses": losses, "ok": ok, "grads": got, "step_ok": step_ok,
            "params": _params(model)}


def dp_spatial_job(cfg: Config, state: Dict[str, np.ndarray],
                   batches: Sequence[Dict], priorities: Sequence[Dict],
                   n_dp: int, shard_caps, halo_caps, device="cpu") -> Dict:
    """On an (n_dp, world / n_dp) mesh: the loss and gradient of
    make_dp_spatial_grad_fn over ``batches`` (one building per dp
    group), then one make_dp_spatial_train_step with its parameters
    after."""
    from detection_3d_tpu_torch.engine.solver import Solver
    from detection_3d_tpu_torch.parallel.spatial import (
        make_dp_spatial_grad_fn, make_dp_spatial_train_step)
    import torch.distributed as dist
    mesh = make_mesh_2d(n_dp, dist.get_world_size() // n_dp, device=device)
    model = _model(cfg, state, mesh.device)
    pri = [_draws(p, mesh.device) for p in priorities]
    total, losses, ok, ovf = make_dp_spatial_grad_fn(
        cfg, mesh, model, shard_caps, halo_caps)(list(batches), None, pri)
    got = grads(model)
    step = make_dp_spatial_train_step(cfg, mesh, model, Solver(cfg, model, 1),
                                      shard_caps, halo_caps)
    _, _, step_ok, _ = step(list(batches), None, pri)
    return {"total": total, "losses": losses, "ok": ok, "overflow": ovf,
            "grads": got, "step_ok": step_ok, "params": _params(model),
            "coords": mesh.coords}


def synced_bn_job(feats: Sequence[np.ndarray], valid: Sequence[np.ndarray],
                  scale: np.ndarray, bias: np.ndarray,
                  cotangent: Sequence[np.ndarray], device="cpu") -> Dict:
    """ops/norm.batch_norm_leaky_relu over rank r's rows ``feats[r]``
    with the statistics summed over every rank: its output and the
    gradients of sum(output * cotangent[r]) in the rows, scale and bias
    (the parameters' gradients are this rank's part; their sum over the
    ranks is the whole)."""
    from detection_3d_tpu_torch.ops.norm import batch_norm_leaky_relu
    mesh = make_mesh(axis="sp", device=device)
    r = mesh.rank
    x, s, b = (torch.tensor(a, device=mesh.device, requires_grad=True)
               for a in (feats[r], scale, bias))
    y = batch_norm_leaky_relu(x, torch.as_tensor(valid[r]).to(mesh.device),
                              s, b, process_group=mesh.group("sp"))
    (y * torch.as_tensor(cotangent[r]).to(mesh.device)).sum().backward()
    return {"out": y.detach(), "d_feats": x.grad, "d_scale": s.grad,
            "d_bias": b.grad}


def masked_bn_group_job(feats: Sequence[np.ndarray],
                        valid: Sequence[np.ndarray], scale: np.ndarray,
                        bias: np.ndarray, cotangent: Sequence[np.ndarray],
                        leakiness: float = 0.0, eps: float = 1e-4,
                        device="cpu") -> Dict:
    """Masked BN over rank r's rows ``feats[r]`` with the statistics
    summed over every rank: autograd through the plain version
    (``plain``), the closed-form backward (``closed``:
    ops/norm.batch_norm_leaky_relu_backward_plain) and, on the card,
    :class:`ops.norm.MaskedBatchNorm` (``function``: the kernels, the
    all-reduce between their passes). Each holds the gradients of
    sum(output * cotangent[r]) in the rows, scale and bias (this rank's
    part); the plain version and the kernels the output too."""
    from detection_3d_tpu_torch.ops.norm import (
        MaskedBatchNorm, batch_norm_leaky_relu_backward_plain,
        batch_norm_leaky_relu_plain)
    mesh = make_mesh(axis="sp", device=device)
    r, group = mesh.rank, mesh.group("sp")
    x, s, b, ct = (torch.as_tensor(a).to(mesh.device)
                   for a in (feats[r], scale, bias, cotangent[r]))
    v = torch.as_tensor(valid[r]).to(mesh.device)
    ways = [("plain", batch_norm_leaky_relu_plain)]
    if x.is_cuda:
        ways.append(("function", MaskedBatchNorm.apply))
    out = {}
    for name, fn in ways:
        xs, ss, bs = (t.clone().requires_grad_() for t in (x, s, b))
        y = fn(xs, v, ss, bs, leakiness, eps, group)
        grads = torch.autograd.grad((y * ct).sum(), (xs, ss, bs))
        out[name] = dict(zip(("out", "d_feats", "d_scale", "d_bias"),
                             (y.detach(),) + grads))
    out["closed"] = dict(zip(
        ("d_feats", "d_scale", "d_bias"),
        batch_norm_leaky_relu_backward_plain(ct, x, v, s, b, leakiness, eps,
                                             group)))
    return out


def _table_fields(t) -> Dict[str, np.ndarray]:
    return {"coords": t.coords, "hi": t.hi, "lo": t.lo, "num": t.num}


def spatial_pyramid_job(cfg: Config, batch: Dict, shard_caps, halo_caps,
                        device="cpu") -> Dict:
    """This shard's parallel/spatial.build_spatial_pyramid of one padded
    building: every extended table, own mask, halo exchange's indices,
    book and BEV table."""
    from detection_3d_tpu_torch.parallel.spatial import (
        build_spatial_pyramid)
    mesh = make_mesh(axis="sp", device=device)
    pts, fts, valid = (torch.as_tensor(batch[k]).to(mesh.device)
                       for k in ("points", "feats", "points_valid"))
    pyr = build_spatial_pyramid(cfg, pts, fts, valid, mesh.group("sp"),
                                shard_caps, halo_caps)
    halo_fields = ("send_lo", "send_lo_ok", "send_hi", "send_hi_ok",
                   "recv_lo", "recv_lo_ok", "recv_hi", "recv_hi_ok")
    return {"tables": [_table_fields(t) for t in pyr["tables"]],
            "own_valid": pyr["own_valid"],
            "halos": [{f: getattr(b.halo, f) for f in halo_fields}
                      for b in pyr["subm"]],
            **{kind: [b.idx for b in pyr[kind]]
               for kind in ("subm", "down", "up")},
            "bev": {slot: (_table_fields(t), b.idx)
                    for slot, (t, b) in pyr["bev"].items()},
            "overflow": pyr["halo_overflow"]}


def shard_kernels_job(cfg: Config, batch: Dict, shard_caps, halo_caps,
                      seed: int = 0) -> Dict:
    """On the card: this shard's training pyramid (kernels B and D on
    extended tables), then kernel D's books against its plain version on
    the same tables, and dFeats and dW (kernel A's code on the
    transposed book, the dW kernel) against their plain versions on
    every submanifold and deconv book of the extended tables. Returns
    per book kind whether D's books are bit equal, and the largest
    difference of dFeats and dW relative to the plain version's
    largest value; and the launches of each kernel."""
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.multi_match import (
        conv_rulebook_match, deconv_rulebook_match)
    from detection_3d_tpu_torch.ops.sparse import SparseTensor
    from detection_3d_tpu_torch.ops.sparse_conv import (
        gather_conv_dfeats, gather_conv_dfeats_cuda, gather_conv_dw,
        gather_conv_dw_cuda)
    from detection_3d_tpu_torch.parallel.spatial import (
        build_spatial_pyramid)
    mesh = make_mesh(axis="sp", device="cuda")
    dev = mesh.device
    pts, fts, valid = (torch.as_tensor(batch[k]).to(dev)
                       for k in ("points", "feats", "points_valid"))
    cuda_lib.reset_launches()
    pyr = build_spatial_pyramid(cfg, pts, fts, valid, mesh.group("sp"),
                                shard_caps, halo_caps, backward=True)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)

    def cpu(t):
        return SparseTensor(t.coords.cpu(), t.feats.cpu(), t.hi.cpu(),
                            t.lo.cpu(), t.num.cpu(), t.spatial_size,
                            t.batch_size, t.true_num.cpu(), t.keys.cpu())

    s3d = cfg.sparse3d
    tables = [cpu(t) for t in pyr["tables"]]
    down_equal = [torch.equal(b.idx.cpu(), conv_rulebook_match(
        tables[k + 1], tables[k], s3d.kernels[k], s3d.strides[k]))
        for k, b in enumerate(pyr["down"])]
    up_equal = [torch.equal(b.idx.cpu(), deconv_rulebook_match(
        tables[k], tables[k + 1], s3d.kernels[k], s3d.strides[k]))
        for k, b in enumerate(pyr["up"])]
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {"dfeats": 0.0, "dw": 0.0}
    for kind in ("subm", "up"):
        for idx, book in ((b.idx, b.bwd) for b in pyr[kind]):
            v_out = idx.shape[1]
            v_in = book.t_idx.shape[1]
            g = torch.randn((v_out, 16), generator=gen, device=dev)
            w = torch.randn((idx.shape[0], 8, 16), generator=gen, device=dev)
            x = torch.randn((v_in, 8), generator=gen, device=dev)
            for name, got, want in (
                    ("dfeats", gather_conv_dfeats_cuda(g, w, book),
                     gather_conv_dfeats(g, w, book)),
                    ("dw", gather_conv_dw_cuda(x, g, book),
                     gather_conv_dw(x, g, book))):
                scale = float(want.abs().max()) or 1.0
                errs[name] = max(errs[name],
                                 float((got - want).abs().max()) / scale)
    return {"down_equal": down_equal, "up_equal": up_equal, "errs": errs,
            "launches": launches,
            "halo_rows": [int(b.halo.recv_lo_ok.sum()
                              + b.halo.recv_hi_ok.sum())
                          for b in pyr["subm"]],
            "overflow": pyr["halo_overflow"]}
