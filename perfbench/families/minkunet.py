"""The MinkUNet family: the port's segmentation network
(``models/minkunet.MinkUNet34C``) trained through ``Trainer.step``, and
its plain reference (reference/minkunet.py), as the harness takes a
model (families/sparse_rcnn.py states what a family gives). It trains
and does not serve, so it has no ``reference_answer`` or
``serving_numbers``.

The configuration's ``model`` holds models/minkunet.MinkUNetConfig's
fields: the pool's ``classes``, ``elements`` (the feature columns
pad_scene keeps; the network reads the colour), the widths
(``out_channels``, ``layers``, ``planes``, ``init_dim``),
``compute_dtype``, ``voxel_full_scale``, ``caps`` (the five levels'
tables, ``max_points``, ``max_gt``) and ``solver``.

The cell's window (windows/labelled_train.py) labels the pool's points
by their boxes once at set-up (traffic/box_labels.py: the smallest box
holding a point, grown by half a voxel, else -1), so the program is the
port's own MinkUNet34C trained on buildings that carry ``point_labels``,
and the reference pads the same labelled buildings.
"""

from __future__ import annotations

import json
import math
from typing import Dict

from perfbench import spec

LIMIT_NAMES = frozenset({"loss", "grad", "change", "change_q90"})
WIDTHS = ("out_channels", "layers", "planes", "init_dim")


def program_config(config_file: Dict, override: Dict = None):
    """The port's ``MinkUNetConfig`` of the file."""
    from detection_3d_tpu_torch.models.minkunet import MinkUNetConfig
    return spec.build_config(MinkUNetConfig, config_file, override)


def reference_config(config_file: Dict):
    """The reference's ``Config`` of the file, in float32."""
    from perfbench.reference.minkunet import Config
    return spec.build_config(Config, config_file,
                             {"compute_dtype": "float32"})


def program_model(cfg):
    """The port's MinkUNet34C on the meta device."""
    from detection_3d_tpu_torch.models.minkunet import MinkUNet34C
    from perfbench.inputs import meta_model
    return meta_model(MinkUNet34C.from_config, cfg)


def reference_model(ref_cfg):
    """The reference's MinkUNet34C on the meta device."""
    from perfbench.inputs import meta_model
    from perfbench.reference.minkunet import MinkUNet34C
    return meta_model(MinkUNet34C, ref_cfg)


def init_std(name: str, shape) -> float:
    """He's N(0, 2 / fan_in) for every weight matrix, fan_in the product
    of all but the last dimension (the port's own initialisation)."""
    return math.sqrt(2.0 / math.prod(shape[:-1]))


def reference_pad(ref_cfg, scene: Dict) -> Dict:
    """The building padded to the configuration's capacities
    (reference/minkunet.pad_scene)."""
    from perfbench.reference.minkunet import pad_scene
    return pad_scene(ref_cfg, scene)


def reference_steps(run, ref, steps: int) -> Dict:
    """The reference's losses, its first update's buffers and gradients,
    and its parameters after the steps (reference/minkunet.step, the
    reference's SGD solver), on the window's first buildings with the
    labels the window gave them."""
    from perfbench.reference import minkunet
    from perfbench.reference.solver import Solver
    ref.train()
    solver = Solver(run.ref_cfg, ref, 1)
    out = {"totals": []}
    names = [n for n, _ in ref.named_parameters()]
    for s in range(steps):
        padded = reference_pad(run.ref_cfg, run.pool[s])
        out["totals"].append(minkunet.step(run.ref_cfg, ref, solver, padded,
                                           run.device))
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
# real (input row, output row) entries of its book, found by the
# reference's own lookup (reference/minkunet.plan) on the building's own
# voxels; a stride-2 conv and its transpose pair each finer voxel once.
# The dense products (the blocks' 1^3 projections and the classifier)
# are 2 * rows * Cin * Cout.

def _pairs(book) -> int:
    return sum(int(dst.numel()) for _, dst in book)


def building_work(ref_cfg, padded: Dict, device, train: bool = False
                  ) -> Dict:
    """The work on one padded building (:func:`reference_pad`): ``flops``
    of the forward (``train``: of a training step, three times the
    forward's products), ``a_convs`` (counts.Conv, the stem first, the
    convs kernel A runs), ``b_books``: kernel B's books of a forward,
    each {"k": offsets, "rows": the level's voxels}, and ``bn_sites``
    (counts.bn_site): the BN after every conv and every 1^3 projection,
    over its level's voxels."""
    import torch
    from perfbench.counts import Conv, bn_site
    from perfbench.reference.minkunet import plan, voxelize
    with torch.no_grad():
        b = {k: torch.as_tensor(padded[k]).to(device)
             for k in ("points", "feats", "points_valid")}
        level0, _, _ = voxelize(ref_cfg, b["points"], b["feats"],
                                b["points_valid"],
                                torch.zeros_like(b["points_valid"],
                                                 dtype=torch.int32))
        p = plan(level0)
    rows = [lv.n for lv in p["levels"]]
    cube = [_pairs(book) for book in p["cube"]]
    planes, layers, c0 = ref_cfg.planes, ref_cfg.layers, ref_cfg.init_dim
    convs = [Conv("stem", 125, _pairs(p["stem"]), rows[0], rows[0], 3, c0)]
    dense, projections = 0.0, []

    def stage(tag, k, cin, c, n):
        nonlocal dense
        for i in range(n):
            ci = cin if i == 0 else c
            convs.append(Conv(f"{tag}.{i}.conv1", 27, cube[k], rows[k],
                              rows[k], ci, c))
            convs.append(Conv(f"{tag}.{i}.conv2", 27, cube[k], rows[k],
                              rows[k], c, c))
            if ci != c:
                dense += 2.0 * rows[k] * ci * c
                projections.append((rows[k], c))

    cin = c0
    for k in range(1, 5):
        convs.append(Conv(f"down{k}", 8, rows[k - 1], rows[k - 1], rows[k],
                          cin, cin))
        stage(f"block{k}", k, cin, planes[k - 1], layers[k - 1])
        cin = planes[k - 1]
    skips = (planes[2], planes[1], planes[0], c0)
    for j in range(4):
        k, c = 3 - j, planes[4 + j]
        convs.append(Conv(f"up{k}", 8, rows[k], rows[k + 1], rows[k], cin,
                          c))
        stage(f"block{5 + j}", k, c + skips[j], c, layers[4 + j])
        cin = c
    dense += 2.0 * rows[0] * cin * ref_cfg.out_channels
    flops = sum(c.flops for c in convs) + dense
    books = [{"k": 27, "rows": r} for r in rows] + \
        [{"k": 125, "rows": rows[0]}]
    sites = [bn_site(c.rows_out, c.cout, train) for c in convs] + \
        [bn_site(r, c, train) for r, c in projections]
    return {"flops": 3 * flops if train else flops, "a_convs": convs,
            "b_books": books, "bn_sites": sites}


# -- the control and the planted faults ----------------------------------

def control(model):
    """The float8 control (control.fp8) over the compute modules: the
    3^3 and 5^3 convs, the stride-2 convs and their transposes, the 1^3
    projections and the classifier."""
    from perfbench.control import fp8
    from perfbench.reference import minkunet
    return fp8(model, (minkunet.CubeConv, minkunet.SampleConv,
                       minkunet.Linear))


def half_voxels(setattr_):
    """The loss keeps the labels of the first half of the table's rows
    only, so it is the mean over the voxels there."""
    import torch
    from detection_3d_tpu_torch.models import minkunet
    real = minkunet.segmentation_loss

    def halved(logits, labels):
        half = torch.arange(labels.shape[0], device=labels.device) < \
            labels.shape[0] // 2
        return real(logits, torch.where(half, labels, -1))
    setattr_(minkunet, "segmentation_loss", halved)


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


FAULTS = {"half_voxels": half_voxels, "altered_total": altered_total,
          "unchanged_state": unchanged_state}


def look(cell, seeds, seconds: float, device):
    """For each seed one line: the spread of the leaves' gaps of the
    program as the configuration states it, of the same program computed
    in float32, and of the control, with the worst leaves by name."""
    import torch
    from perfbench import harness as bench
    from perfbench.control import leaf_summary
    from perfbench.inputs import load
    steps = int(cell.traffic["checked_steps"])
    for seed in seeds:
        run = bench.prepare(cell, seed, seconds, False, device)
        bench.drive(run)
        got = bench.close_window(run)
        line = {"seed": seed, "kind": run.kind}
        want = reference_steps(run, bench.reference_model(run), steps)
        line["program"] = leaf_summary(got, want, run.weights)
        run.cfg = program_config(cell.config, {"compute_dtype": "float32"})
        run.model = load(program_model(run.cfg), run.weights, device)
        bench.drive(run)
        line["program_float32"] = leaf_summary(bench.close_window(run), want,
                                               run.weights)
        ctl = reference_steps(run, bench.reference_model(run, control),
                              steps)
        line["control"] = leaf_summary(ctl, want, run.weights)
        print(json.dumps(line), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
