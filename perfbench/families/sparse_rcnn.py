"""The Sparse R-CNN family: the port's detector (``models/detector.
SparseRCNN``) and the reference's plain copy of it (reference/), as the
harness takes a model.

A family file (``families/<family>.py``, named by a configuration's
top-level ``family``; spec.family loads it) is everything of one kind of
model that the harness, the control tool and the readers use; this one
imports torch, the port and the reference inside its functions. It
gives:

  program_config(config_file, override=None)  the program's configuration
      from the file's ``model`` object; it has ``compute_dtype``, the
      name of a torch dtype, which the readers' bytes and peaks take;
  reference_config(config_file)  the reference's, in float32;
  program_model(cfg), reference_model(ref_cfg)  each side's model on the
      meta device (inputs.meta_model); the two state_dicts have the same
      names and shapes, the weights the run makes;
  init_std(name, shape)  the standard deviation of a weight matrix's
      draw (inputs.make_weights: vectors named ``*scale`` are ones, the
      other vectors zeros);
  reference_pad(ref_cfg, scene)  a pool building as the reference reads
      it;
  reference_answer(run, model, building)  the answer of ``model`` (the
      reference or the control) to pool building ``building``, in the
      form a serving window returns the program's;
  serving_numbers(run, answer, ref, building)  the numbers of the
      program's ``answer`` to pool building ``building`` against the
      reference ``ref``'s, each compared by the limit of its name;
  reference_steps(run, ref, steps)  the reference's first ``steps``
      training steps on the program's buildings and draws
      (``run.draws``), in the form of the training window's record
      (train.numbers compares the two);
  building_work(ref_cfg, padded, device, train=False)  {"flops": the
      operations of a forward (``train``: of a training step),
      "a_convs": [counts.Conv] of the forward's sparse convs, and what
      other kernels' readers take where the family counts it:
      "b_books", "bn_sites" (counts.bn_site), "roi_pools"
      (counts.roi_pool)}, which metrics/ read;
  LIMIT_NAMES  the names ``limits/<cell>.json`` may give a limit;
  WIDTHS  the widths of the model, as dotted keys under the file's
      ``model``; both sides' configurations hold each at the same
      attribute path, with the file's value (the tests check it);
  control(model)  the reference ``model`` turned into the control, in
      place (control.py);
  FAULTS  {name: plant(setattr)}: the faults planted in the program's
      training step that its check has to fail (control.py);

and, for ``python3 -m perfbench.control --look``, ``look(cell, seeds,
seconds, device)``. A family that serves and does not train leaves out
``reference_steps`` and ``FAULTS``, one that trains and does not serve
``reference_answer`` and ``serving_numbers``.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List

from perfbench import spec

LIMIT_NAMES = frozenset({"unmatched", "score_gap_median", "loss", "grad",
                         "change", "change_q90"})
WIDTHS = ("backbone_out_channels", "sparse3d.nplanes_front",
          "sparse3d.nplane_map", "roi.mlp_head_dim", "roi.pooler_resolution")


def program_config(config_file: Dict, override: Dict = None):
    """The port's ``Config`` of the file."""
    from detection_3d_tpu_torch.config.defaults import Config
    return spec.build_config(Config, config_file, override)


def reference_config(config_file: Dict):
    """The reference's ``Config`` of the file, in float32."""
    from perfbench.reference.config import Config
    return spec.build_config(Config, config_file,
                             {"compute_dtype": "float32"})


def program_model(cfg):
    """The port's ``SparseRCNN`` on the meta device."""
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from perfbench.inputs import meta_model
    return meta_model(SparseRCNN, cfg)


def reference_model(ref_cfg):
    """The reference's ``SparseRCNN`` on the meta device."""
    from perfbench.inputs import meta_model
    from perfbench.reference.detector import SparseRCNN
    return meta_model(SparseRCNN, ref_cfg)


def init_std(name: str, shape) -> float:
    """The program's rule in scale: the RPN head and the ROI classifier
    N(0, 0.01), the ROI box regressor N(0, 0.001), every other weight
    He's N(0, 2 / fan_in) with fan_in the product of all but the last
    dimension."""
    if name.startswith("rpn.head."):
        return 0.01
    if name.endswith("predictor.cls_w"):
        return 0.01
    if name.endswith("predictor.box_w"):
        return 0.001
    return math.sqrt(2.0 / math.prod(shape[:-1]))


def reference_pad(ref_cfg, scene: Dict) -> Dict:
    """The building padded to the configuration's capacities
    (reference/train.pad_scene)."""
    from perfbench.reference.train import pad_scene
    return pad_scene(ref_cfg, scene)


def reference_answer(run, model, building: int) -> Dict:
    """``model``'s detections of the building, numpy, valid rows only:
    {boxes (K, 7), scores (K,), labels (K,)}."""
    import torch
    from perfbench.reference.detector import voxelize_points
    padded = reference_pad(run.ref_cfg, run.pool[building])
    with torch.no_grad():
        pts, fts, valid = (torch.as_tensor(padded[k]).to(run.device)
                           for k in ("points", "feats", "points_valid"))
        det = model(voxelize_points(run.ref_cfg, pts, fts, valid))
        v = det.valid.cpu().numpy()
        return {"boxes": det.boxes.cpu().numpy()[v],
                "scores": det.fields["scores"].cpu().numpy()[v],
                "labels": det.fields["labels"].cpu().numpy()[v]}


def serving_numbers(run, answer: Dict, ref, building: int
                    ) -> Dict[str, float]:
    """compare.building_numbers of the program's detections against the
    reference's."""
    from perfbench import compare
    return compare.building_numbers(answer,
                                    reference_answer(run, ref, building))


def reference_steps(run, ref, steps: int) -> Dict:
    """The reference's losses, its first update's buffers and gradients,
    and its parameters after the steps (reference/train.step, its own
    SGD solver)."""
    from perfbench.reference import train as ref_train
    from perfbench.reference.solver import Solver
    ref.train()
    solver = Solver(run.ref_cfg, ref, 1)
    out = {"totals": []}
    names = [n for n, _ in ref.named_parameters()]
    for s in range(steps):
        pri = {k: v.to(run.device) for k, v in run.draws[s].items()}
        losses = ref_train.step(
            run.ref_cfg, ref, solver, ref_train.pad_scene(run.ref_cfg,
                                                          run.pool[s]),
            pri, run.device)
        out["totals"].append(sum(losses[k] for k in sorted(losses)))
        if s == 0:
            bufs = solver.optimizer.state
            out["first"] = {n: bufs[p]["momentum_buffer"].cpu().clone()
                            for n, p in ref.named_parameters()}
            out["grad"] = {n: p.grad.detach().cpu().clone()
                           for n, p in ref.named_parameters()}
    out["after"] = {n: p.detach().cpu().clone()
                    for n, p in zip(names, ref.parameters())}
    return out


# -- the work of one building --------------------------------------------
#
# A sparse conv's operations are 2 * pairs * Cin * Cout, its pairs the
# real (input row, output row) entries of its rulebook, found by the
# reference's own plain search (reference/backbone.build_pyramid) on the
# building's own voxels. Only the layers the forward computes are counted
# (the decoder stops at the deepest map a head reads). A dense product's
# operations are 2 * rows * Cin * Cout over the valid rows.

def _pairs(book, v_in: int, out_valid) -> int:
    return int(((book != v_in) & out_valid[None, :]).sum())


def forward_convs(cfg, pyr) -> List:
    """Every sparse conv the forward computes (counts.Conv), from the
    reference's pyramid ``pyr`` of one building (the inventory of
    SparseFPN)."""
    from perfbench.counts import Conv
    s3d = cfg.sparse3d
    n, planes, c_map = s3d.num_scales, s3d.nplanes_front, s3d.nplane_map
    tables = pyr["tables"]
    rows = [int(t.row_valid.sum()) for t in tables]
    subm = [_pairs(idx, t.capacity, t.row_valid)
            for idx, t in zip(pyr["subm_idx"], tables)]
    convs = [Conv("conv_in", 27, subm[0], rows[0], rows[0],
                  cfg.in_channels, planes[0])]
    for k in range(n):
        if k > 0:
            rb = pyr["down_rb"][k - 1]
            convs.append(Conv(f"down{k}", rb.shape[0],
                              _pairs(rb, tables[k - 1].capacity,
                                     tables[k].row_valid),
                              rows[k - 1], rows[k], planes[k - 1], planes[k]))
        for r in range(s3d.block_reps):
            for c in (1, 2) if s3d.residual_block else (1,):
                convs.append(Conv(f"block{k}_{r}.conv{c}", 27, subm[k],
                                  rows[k], rows[k], planes[k], planes[k]))
    n3d = len(cfg.rpn.rpn_scales_from_top)
    sel = cfg.rpn.rpn_3d_2d_selector
    used = {cfg.rpn.rpn_scales_from_top[i % n3d] for i in sel}
    used |= set(cfg.roi.pooler_scales_from_top)
    for i, k in enumerate(range(n - 1, 0, -1)):
        if i >= max(used):
            break
        j = k - 1
        rb = pyr["up_rb"][i]
        convs.append(Conv(f"up{j}", rb.shape[0],
                          _pairs(rb, tables[k].capacity, tables[j].row_valid),
                          rows[k], rows[j], c_map, c_map))
        convs.append(Conv(f"merge{j}", 27, subm[j], rows[j], rows[j],
                          c_map, c_map))
    for i in sel:
        if i < n3d:
            continue
        slot = i % n3d
        t3d = tables[n - 1 - cfg.rpn.rpn_scales_from_top[slot]]
        bev_t, rb = pyr["bev"][slot]
        convs.append(Conv(f"pro2d{slot}", rb.shape[0],
                          _pairs(rb, t3d.capacity, bev_t.row_valid),
                          int(t3d.row_valid.sum()),
                          int(bev_t.row_valid.sum()), c_map, c_map))
    return convs


def dense_flops(cfg, pyr, train: bool = False) -> float:
    """The forward's dense products: the NiN shortcuts the decoder
    reads, the RPN head on every selected map's valid rows, and the ROI
    head on each group's post-NMS proposals (``train``: on each group's
    sampled rows)."""
    s3d = cfg.sparse3d
    n, planes, c_map = s3d.num_scales, s3d.nplanes_front, s3d.nplane_map
    tables = pyr["tables"]
    rows = [int(t.row_valid.sum()) for t in tables]
    n3d = len(cfg.rpn.rpn_scales_from_top)
    sel = cfg.rpn.rpn_3d_2d_selector
    used = {cfg.rpn.rpn_scales_from_top[i % n3d] for i in sel}
    used |= set(cfg.roi.pooler_scales_from_top)
    f = 2.0 * rows[-1] * planes[-1] * c_map
    for i, k in enumerate(range(n - 1, 0, -1)):
        if i >= max(used):
            break
        f += 2.0 * rows[k - 1] * planes[k - 1] * c_map
    a = cfg.rpn.num_anchors_per_location
    g = cfg.group_num if cfg.separate_rpn else 1
    for i in sel:
        slot = i % n3d
        if i < n3d:
            r = rows[n - 1 - cfg.rpn.rpn_scales_from_top[slot]]
        else:
            r = int(pyr["bev"][slot][0].row_valid.sum())
        f += 2.0 * r * c_map * (c_map + a * g + a * 7 * g)
    os0, os1, os2 = cfg.roi.pooler_resolution
    rep = cfg.roi.mlp_head_dim
    nc = cfg.num_classes + len(cfg.separate_classes)
    per_roi = 2.0 * (os0 * os1 * os2 * c_map * rep + os0 * os1 * rep * rep
                     + rep * rep + rep * nc * 8)
    groups = cfg.group_num if cfg.separate_classes else 1
    rois = cfg.roi_batch_size_per_image if train else \
        cfg.rpn_post_nms_top_n_test
    return f + groups * rois * per_roi


def building_work(ref_cfg, padded: Dict, device, train: bool = False
                  ) -> Dict:
    """The work on one padded building (:func:`reference_pad`): ``flops``
    of the whole forward (``train``: of the forward and its backward,
    three times the forward's products), ``a_convs``, the sparse convs
    of kernel A, and of a served forward ``roi_pools`` (counts.roi_pool):
    a pooler call a group, over the post-NMS proposals and the valid
    rows of the pooled levels' merged table."""
    import torch
    from perfbench.reference.backbone import build_pyramid
    from perfbench.reference.detector import voxelize_points
    with torch.no_grad():
        pts, fts, valid = (torch.as_tensor(padded[k]).to(device)
                           for k in ("points", "feats", "points_valid"))
        pyr = build_pyramid(voxelize_points(ref_cfg, pts, fts, valid),
                            ref_cfg)
        convs = forward_convs(ref_cfg, pyr)
        flops = sum(c.flops for c in convs) + dense_flops(ref_cfg, pyr,
                                                          train)
    work = {"flops": 3 * flops if train else flops, "a_convs": convs}
    if not train:
        work["roi_pools"] = roi_pools(ref_cfg, pyr)
    return work


def roi_pools(cfg, pyr) -> List:
    """The served forward's pooler calls (counts.roi_pool): one a group,
    each over the group's post-NMS proposals (the output's rois), from
    one table that merges the pooled levels' valid rows."""
    from perfbench.counts import roi_pool
    n = cfg.sparse3d.num_scales
    rows = sum(int(pyr["tables"][n - 1 - s].row_valid.sum())
               for s in cfg.roi.pooler_scales_from_top)
    os0, os1, os2 = cfg.roi.pooler_resolution
    groups = cfg.group_num if cfg.separate_classes else 1
    return [roi_pool(cfg.rpn_post_nms_top_n_test, os0 * os1 * os2,
                     cfg.sparse3d.nplane_map, rows)] * groups


# -- the control and the planted faults ----------------------------------

def control(model):
    """The float8 control (control.fp8) over the compute modules: the
    sparse convs, the NiN shortcuts, the down and up layers, the BEV
    convs, the RPN head, the ROI feature extractor and predictor."""
    from perfbench.control import fp8
    from perfbench.reference import backbone, roi_head, rpn
    return fp8(model, (backbone.SubmConv, backbone.NiN, backbone.DownLayer,
                       backbone.BEVConv, rpn.RPNHead,
                       roi_head.ROIBoxFeatureExtractor,
                       roi_head.ROIPredictor))


def half_batch(setattr_):
    """Every balanced sample keeps its first half of rows only, so each
    loss is the mean over the rest."""
    import torch
    from detection_3d_tpu_torch.models import matcher, roi_head, rpn
    real = matcher.balanced_sample

    def halved(labels, priorities, batch_size, positive_fraction):
        pos, neg = real(labels, priorities, batch_size, positive_fraction)
        half = torch.arange(labels.shape[-1], device=labels.device) < \
            labels.shape[-1] // 2
        return pos & half, neg & half
    for mod in (rpn, roi_head):
        setattr_(mod, "balanced_sample", halved)


def altered_total(setattr_):
    """The step's total loss, which the step reports and whose gradient
    makes the update, comes out doubled."""
    from detection_3d_tpu_torch.engine import trainer
    real = trainer.total_loss
    setattr_(trainer, "total_loss", lambda losses: 2.0 * real(losses))


def unchanged_state(setattr_):
    """The step leaves the parameters as they were."""
    from detection_3d_tpu_torch.engine.solver import Solver
    setattr_(Solver, "apply", lambda self, ok=None: None)


FAULTS = {"half_batch": half_batch, "altered_total": altered_total,
          "unchanged_state": unchanged_state}


# -- the look behind the training check's numbers (control.py --look) ----

class _Positives:
    """Records the ROI head's sampled positives (their proposals' boxes)
    of every ``subsample_proposals`` call of a detector module."""

    def __init__(self, module, patches):
        self.calls = []
        real = module.subsample_proposals

        def recorded(*a, **k):
            out = real(*a, **k)
            pos = (out.valid & (out.fields["labels"] > 0)).reshape(-1)
            self.calls.append(out.boxes.reshape(-1, 7)[pos].float().cpu())
            return out
        patches(module, "subsample_proposals", recorded)


def _shared(got, want, tol: float = 0.01):
    """[program's positives, reference's, positives within ``tol`` of one
    of the other side's] of each call the reference made."""
    out = []
    for a, b in zip(got, want):
        hit = 0
        if len(a) and len(b):
            hit = int(((a[:, None, :] - b[None, :, :]).abs().amax(-1)
                       <= tol).any(1).sum())
        out.append([len(a), len(b), hit])
    return out


def look(cell, seeds, seconds: float, device):
    """For each seed one line: the spread of the leaves' gaps of the
    program as the configuration states it, of the same program computed
    in float32, and of the control, with the worst leaves by name; and
    the ROI head's sampled positives of each program against the
    reference's."""
    import torch
    from detection_3d_tpu_torch.models import detector
    from perfbench import harness as bench
    from perfbench.control import Patches, leaf_summary
    from perfbench.inputs import load
    from perfbench.reference import detector as ref_detector
    steps = int(cell.traffic["checked_steps"])
    for seed in seeds:
        run = bench.prepare(cell, seed, seconds, False, device)
        line = {"seed": seed, "kind": None}
        patches = Patches()
        try:
            mine = _Positives(detector, patches)
            bench.drive(run)
            got = bench.close_window(run)
            line["kind"] = run.kind
            run.draws = got["draws"]
            ref_pos = _Positives(ref_detector, patches)
            want = reference_steps(run, bench.reference_model(run), steps)
            line["program"] = leaf_summary(got, want, run.weights)
            line["roi_positives"] = _shared(mine.calls, ref_pos.calls)
            patches.restore()
            mine = _Positives(detector, patches)
            run.cfg = program_config(cell.config,
                                     {"compute_dtype": "float32"})
            run.model = load(program_model(run.cfg), run.weights, device)
            bench.drive(run)
            got32 = bench.close_window(run)
            line["program_float32"] = leaf_summary(got32, want, run.weights)
            line["roi_positives_float32"] = _shared(mine.calls,
                                                    ref_pos.calls)
        finally:
            patches.restore()
        ctl = reference_steps(run, bench.reference_model(run, control),
                              steps)
        line["control"] = leaf_summary(ctl, want, run.weights)
        print(json.dumps(line), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
