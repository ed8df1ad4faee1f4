"""Training engine: one optimizer step per building, the epoch loop, the
scanned loop and device-resident training.

Counterpart of detection_3d_tpu/engine/trainer.py (reference
engine/trainer_sparse3d.py:42-172) for one device: per-step schedule,
the NaN gate (a step whose loss or any gradient is non-finite changes
nothing), bad-scene strikes and culling, windowed metric logging, the
min-loss checkpoint and periodic / final checkpoints.

A step runs pad (data/packing.pad_scene) -> the model's
``training_losses`` (the detector's: voxelize_points -> forward with gt,
four losses or four per separate-classifier group) -> sum of the
losses -> backward -> one fused isfinite over the loss and every
gradient -> the SGD update, committed on the device only where that
isfinite holds (engine/solver.py). A packed step (``packed="pyramid"``)
takes a host-packed pyramid with its backward books
(data/pyramid_packing.pack_pyramid(..., backward=True)) instead of the
padded points: the card runs no voxelization, sort, scatter or search.
The uniform draws of the two samplers come from one ``torch.Generator``
on the device, seeded by ``train``'s seed. With ``cfg.eval_in_train`` =
N, every N-th epoch (epoch 0 included) pools each step's train-time
detections and evaluates them at the epoch's end
(``Trainer.last_train_eval``).

``scenes`` is a list of scene dicts or a loader with ``__len__`` and
``epoch(order)`` (data/native_loader.NativeSceneLoader). With
``scan_steps`` = K > 1, K steps run back to back with no host fetch
between them and their results come back in one fetch (the forward's
own host syncs, the greedy NMS and the ``.item()``s, remain).
:meth:`Trainer.train_resident` packs every scene once, keeps the packs
on the device and trains in chunks of such gated steps.

With a ``mesh`` (parallel/mesh.make_mesh, one process per rank) a step
is data-parallel, as JAX's batched step: it takes ``bsz = max(
ims_per_batch, dp)`` buildings rounded up to a multiple of dp, each
rank runs its bsz / dp of them in JAX's sharding order (rank r the r-th
run of them) through parallel/mesh.batched_train_step (one all-reduce
of the loss sums and every gradient; the NaN gate on the reduced
buffer), each rank's samplers draw from a generator seeded from (seed,
rank), the eval-in-train detections are gathered from every rank,
``scan_steps`` is off, and only rank 0 logs and writes checkpoints.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.data.packing import batch_to_device, pad_scene
from detection_3d_tpu_torch.engine.solver import Solver
from detection_3d_tpu_torch.evaluation.detection_eval import (
    eval_aug_thickness, evaluate_detections,
)
from detection_3d_tpu_torch.models.detector import SparseRCNN, voxelize_points
from detection_3d_tpu_torch.parallel.mesh import (
    batched_train_step, dp_batch_size, rank_generator)
from detection_3d_tpu_torch.utils.checkpoint import Checkpointer
from detection_3d_tpu_torch.utils.device import resolve_device
from detection_3d_tpu_torch.utils.metric_logger import MetricLogger
from detection_3d_tpu_torch.utils.profiling import span


def check_capacities(cfg: Config, scene: Dict, logger=None, device="cuda"):
    """Build the voxel pyramid of one scene and report per-scale true
    voxel counts against the configured capacities, warning where the
    input layer subsampled. Returns a list of (true_num, capacity)."""
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    dev = resolve_device(device)
    (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, scene), dev)
    pyr = build_pyramid(voxelize_points(cfg, pts, fts, valid), cfg)
    out = []
    for k, t in enumerate(pyr["tables"]):
        tn, cap = int(t.true_num), t.capacity
        out.append((tn, cap))
        if tn > cap and logger:
            logger.warning(
                "scale %d: %d active voxels exceed capacity %d "
                "(subsampled %.0f%%) — raise caps.voxel_caps[%d]",
                k, tn, cap, 100.0 * (1 - cap / tn), k)
    return out


def pack_detections(det) -> torch.Tensor:
    """A Boxes3D of detections as one (K, 10) f32 tensor ``[boxes7 |
    score | label | valid]`` (the serving output's packed form); a
    unit's as (B, K, 10)."""
    return torch.cat([det.boxes, det.fields["scores"][..., None],
                      det.fields["labels"].to(torch.float32)[..., None],
                      det.valid.to(torch.float32)[..., None]], -1)


def unpack_detections(packed: np.ndarray) -> Dict[str, np.ndarray]:
    """The valid rows of a (K, 10) ``[boxes7 | score | label | valid]``
    detections array as {boxes, scores, labels}."""
    v = packed[:, 9] > 0.5
    return {"boxes": packed[v, :7], "scores": packed[v, 7],
            "labels": packed[v, 8].astype(np.int32)}


def cycle_pad(order: list, k: int) -> list:
    """Pad ``order`` to a multiple of ``k`` by cycling it (correct even
    when the pad exceeds len(order))."""
    if len(order) % k:
        pad = k - len(order) % k
        order = order + (order * (pad // len(order) + 1))[:pad]
    return order


@dataclass
class TrainState:
    """The model (its parameters), the solver (momentum and schedule
    clock) and the number of steps taken, applied or skipped."""
    model: torch.nn.Module
    solver: Solver
    step: int = 0

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.solver.state_dict(), "step": self.step}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        self.solver.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def total_loss(losses: Dict[str, torch.Tensor]):
    """Sum of the loss dict in key order (the JAX trainer sums its leaves
    in sorted-key order)."""
    return sum(losses[k] for k in sorted(losses))


def grads_finite(total, params):
    """One fused isfinite over the loss and every gradient (None counts
    as zero): a bool tensor on the loss's device, read by no one on the
    host."""
    grads = [p.grad.reshape(-1) for p in params if p.grad is not None]
    flat = torch.cat([total.detach().reshape(1).to(torch.float32)]
                     + [g.to(torch.float32) for g in grads])
    return torch.isfinite(flat).all()


def chunk_generator(seed: int, chunk_index: int, device) -> torch.Generator:
    """The sampler generator of ``train_resident``'s chunk ``chunk_index``,
    seeded from (seed, chunk_index) alone, so a chunk draws the same
    whether or not the chunks before it ran in this process."""
    words = np.random.SeedSequence((seed + 123, chunk_index)).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(words[0]) << 32 | int(words[1]))


class Trainer:
    """Training loop on one device (on the card unless ``device`` says
    the CPU; asking for the card without one raises), or data-parallel
    over a ``mesh`` (parallel/mesh.Mesh, ``dp`` axis) on the mesh's
    device, ``device`` unused."""

    def __init__(self, cfg: Config, output_dir: Optional[str] = None,
                 logger=None, device="cuda", mesh=None):
        if mesh is not None and mesh.axes != ("dp",):
            raise ValueError(f"Trainer: a data-parallel mesh has the one "
                             f"axis 'dp', this mesh has {mesh.axes} (train "
                             f"a spatially sharded model with "
                             f"parallel/spatial's steps)")
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.is_main = mesh is None or mesh.is_main
        # only the first rank logs and writes files
        self.logger = logger if self.is_main else None
        self.output_dir = output_dir or cfg.output_dir
        self.checkpointer = Checkpointer(self.output_dir, self.logger)
        self.meters = MetricLogger()
        self.min_loss = float("inf")
        self.min_save_every = 50
        self._last_min_save = -(10 ** 9)
        # non-finite steps a scene may contribute before it is culled
        # from the rotation (reference: curated SceneSamples.bad_scenes)
        self.bad_scene_strikes = 3
        self.scan_steps = 1
        self.history = []
        # eval_in_train: the last step's train-time detections (numpy,
        # valid rows) and the last evaluated epoch's DetectionEvalResult
        self.last_detections = None
        self.last_train_eval = None

    def init_state(self, example_scene: Optional[Dict] = None,
                   seed: int = 0, iters_per_epoch: int = 1,
                   model: Optional[torch.nn.Module] = None) -> TrainState:
        """A fresh state: ``model`` (moved to the device; any model with
        a ``training_losses`` method, as SparseRCNN and MinkUNet34C have)
        or a SparseRCNN drawn from ``seed``; the example scene is not needed
        (the port's modules know their shapes) and is accepted for the
        JAX trainer's signature."""
        model = (model if model is not None
                 else SparseRCNN(self.cfg, seed=seed)).to(self.device)
        if self.mesh is not None:     # every rank starts from rank 0's
            with torch.no_grad():
                for t in model.state_dict().values():
                    torch.distributed.broadcast(t, 0)
        model.train()
        return TrainState(model, Solver(self.cfg, model, iters_per_epoch))

    def _persist_bad_scenes(self, names):
        """Write the culled blocklist to <output_dir>/bad_scenes.json."""
        if not self.is_main:
            return
        path = os.path.join(self.output_dir, "bad_scenes.json")
        os.makedirs(self.output_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(sorted(names), f)

    def _device_step(self, state: TrainState, batch, generator, priorities,
                     packed):
        """One gated step with no host fetch: ((total, losses, ok,
        true_num) as tensors on the device, the step's train-time
        detections on the device with ``cfg.eval_in_train``, else
        None), in the spans ``train.forward``, ``train.backward`` and
        ``train.update``."""
        state.solver.zero_grad()
        with span("train.forward"):
            losses, dets, true_num = state.model.training_losses(
                self.cfg, batch, self.device, generator, priorities, packed)
            total = total_loss(losses)
        with span("train.backward"):
            total.backward()
        with span("train.update"):
            ok = grads_finite(total, state.solver.params)
            state.solver.apply(ok)
        state.step += 1
        return (total.detach(), {k: v.detach() for k, v in losses.items()},
                ok, true_num), dets

    @staticmethod
    def _fetch(outs):
        """The host numbers of device steps in ONE copy: a list of
        (total, losses, ok, true_num)."""
        names = list(outs[0][1])
        vals = torch.stack([torch.stack(
            [total.double(), *(losses[k].double() for k in names),
             ok.double(), tn.double()])
            for total, losses, ok, tn in outs]).cpu().numpy()
        return [(float(v[0]), {k: float(x) for k, x in zip(names, v[1:-2])},
                 bool(v[-2]), int(v[-1])) for v in vals]

    def step(self, state: TrainState, batch: Dict[str, np.ndarray],
             generator: Optional[torch.Generator] = None, priorities=None,
             packed=False):
        """One training step on a padded batch (``packed=False``) or on a
        pack_pyramid(..., backward=True) dict (``packed="pyramid"``,
        numpy or tensors already on the device). Returns (total, losses,
        ok, true_num) as host numbers; the update is applied only when
        ``ok`` (finite loss and gradients). With ``cfg.eval_in_train``,
        ``self.last_detections`` holds the step's train-time detections
        ({boxes, scores, labels} of the valid rows, numpy). Runs in the
        span ``train.step`` around ``train.forward``, ``train.backward``,
        ``train.update`` (the isfinite and the SGD update) and
        ``train.fetch``."""
        with span("train.step"):
            out, dets = self._device_step(state, batch, generator,
                                          priorities, packed)
            with span("train.fetch"):
                if dets is not None:
                    self.last_detections = unpack_detections(
                        pack_detections(dets).cpu().numpy())
                return self._fetch([out])[0]

    def scan(self, state: TrainState, batches, generator=None,
             packed=False):
        """``len(batches)`` steps back to back (``step``'s forms), each
        gated on the device, with no host fetch between them; their
        (total, losses, ok, true_num) come back in one fetch."""
        return self._fetch([self._device_step(state, b, generator, None,
                                              packed)[0] for b in batches])

    def _save(self, name, state: TrainState):
        if self.is_main:
            self.checkpointer.save(name, state.state_dict())

    def batch_size(self) -> int:
        """Buildings a step takes: 1, or under a mesh ``ims_per_batch``
        rounded up to a multiple of the ranks (at least one each)."""
        if self.mesh is None:
            return 1
        return dp_batch_size(self.cfg.solver.ims_per_batch,
                             self.mesh.size("dp"))

    def dp_step(self, state: TrainState, batches, generator=None,
                priorities=None):
        """One data-parallel step (parallel/mesh.batched_train_step) over
        this rank's padded ``batches``; returns (total, losses, ok,
        true_num) as host numbers, the same on every rank. With
        ``cfg.eval_in_train``, ``self.last_detections`` becomes the list
        of every building's train-time detections, in batch order."""
        total, losses, ok, tn, dets = batched_train_step(
            self.cfg, state.model, state.solver, self.mesh)(
                batches, generator, priorities)
        state.step += 1
        if dets is not None:
            self.last_detections = [unpack_detections(d)
                                    for d in dets.cpu().numpy()]
        return self._fetch([(total, losses, ok, tn)])[0]

    def train(self, scenes, state: TrainState, epochs: int, seed: int = 0,
              checkpoint_period_epochs: Optional[int] = None):
        """``epochs`` passes over ``scenes`` (a list of scene dicts, or a
        loader with ``__len__`` and ``epoch(order)``), in a fresh shuffle
        each epoch, one building per step; with ``scan_steps`` = K > 1,
        K steps per :meth:`scan` (the order cycle-padded to K), except in
        an eval-in-train epoch. Returns the state; ``self.history`` holds
        one (total, losses, ok, seconds) per step, the seconds on the
        host clock from the fetch of the step's scene (a loader's wait
        included) through its padding to the losses on the host (so the
        clock covers its device work; a scanned step is its group's
        mean). An eval-in-train epoch's result lands in
        ``self.last_train_eval``."""
        cfg = self.cfg
        source = scenes if hasattr(scenes, "epoch") else None
        if source is None:
            scenes = list(scenes)
        n_scenes = len(scenes)
        ckpt_period = checkpoint_period_epochs or \
            cfg.solver.checkpoint_period_epochs
        mesh = self.mesh
        if mesh is None:
            gen = torch.Generator(device=self.device).manual_seed(seed + 123)
        else:
            gen = rank_generator(seed, mesh.coord("dp"), self.device)
        bsz = self.batch_size()
        shuffle_rng = np.random.default_rng(seed + 77)
        cap0 = cfg.caps.scale_caps(cfg.sparse3d.num_scales)[0]
        strikes = np.zeros(n_scenes, np.int64)
        culled: set = set()
        culled_names: list = []
        self.history = []
        state.model.train()
        it = 0
        t_start = time.time()
        for epoch in range(epochs):
            # eval-in-train (JAX trainer.py:546-548, reference
            # trainer_sparse3d.py:95-104,165-172): pool this epoch's
            # train-time detections and evaluate them at its end
            eval_this_epoch = (cfg.eval_in_train > 0
                               and epoch % cfg.eval_in_train == 0)
            epoch_preds, epoch_gts = [], []
            order = [i for i in shuffle_rng.permutation(n_scenes)
                     if i not in culled]
            if not order:
                raise RuntimeError(
                    "trainer: every scene was culled as bad "
                    f"({len(culled)} scenes with >= "
                    f"{self.bad_scene_strikes} non-finite steps)")
            if mesh is not None:     # one data-parallel step of bsz
                stride = bsz
            else:
                stride = self.scan_steps if not eval_this_epoch else 1
            order = cycle_pad(order, stride)
            loaded = iter(source.epoch(order) if source is not None
                          else (scenes[i] for i in order))
            for start in range(0, len(order), stride):
                sids = order[start:start + stride]
                t0 = time.perf_counter()
                group = [next(loaded) for _ in sids]
                if mesh is not None:
                    # rank r takes the r-th run of the step's buildings
                    lb = bsz // mesh.size("dp")
                    r = mesh.coord("dp")
                    results = [self.dp_step(
                        state, [pad_scene(cfg, sc)
                                for sc in group[r * lb:(r + 1) * lb]], gen)]
                    dt = time.perf_counter() - t0
                    steps = [(sids, group)]
                elif stride > 1:
                    results = self.scan(state, [pad_scene(cfg, sc)
                                                for sc in group], gen)
                    dt = (time.perf_counter() - t0) / stride
                    steps = [([si], [sc]) for si, sc in zip(sids, group)]
                else:
                    results = [self.step(state, pad_scene(cfg, group[0]),
                                         gen)]
                    dt = time.perf_counter() - t0
                    steps = [(sids, group)]
                for (total, losses, ok, true_num), (step_sids, step_scenes) \
                        in zip(results, steps):
                    self.history.append((total, losses, ok, dt))
                    if eval_this_epoch:
                        dets = self.last_detections
                        epoch_preds += dets if mesh is not None else [dets]
                        epoch_gts += [{"boxes": sc["gt_boxes"],
                                       "labels": sc["gt_labels"]}
                                      for sc in step_scenes]
                    if true_num > cap0 and self.logger:
                        self.logger.warning(
                            "iter %d: %d voxels exceed scale-0 capacity %d "
                            "— input subsampled (raise caps)", it, true_num,
                            cap0)
                    self.meters.update(loss=total, time=dt, **losses)
                    for si, scene in zip(step_sids, step_scenes):
                        if ok:      # a non-finite step strikes its scenes
                            break
                        # a loader's scene is named by its index (JAX
                        # trainer.py:683-685)
                        name = str(si if source is not None
                                   else scene.get("scene_name", si))
                        self._strike(si, name, strikes, culled,
                                     culled_names, n_scenes, it)
                    if self.logger and it % 20 == 0:
                        eta = (time.time() - t_start) / (it + 1) * \
                            (epochs * -(-n_scenes // bsz) - it - 1)
                        self.logger.info(
                            "iter %d epoch %d eta %.0fs lr %.5f %s", it,
                            epoch, eta, state.solver.lr(state.solver.count),
                            self.meters)
                    # min-loss checkpoint: track the minimum every step,
                    # write at most once per min_save_every steps (under
                    # scanning the state is the group's final one, as in
                    # JAX trainer.py:699-703)
                    if np.isfinite(total) and total < self.min_loss:
                        self.min_loss = total
                        if it - self._last_min_save >= self.min_save_every:
                            self._last_min_save = it
                            self._save("model_min_loss", state)
                    it += 1
            if eval_this_epoch and epoch_preds:
                self._evaluate_epoch(epoch, epoch_preds, epoch_gts)
            if (epoch + 1) % ckpt_period == 0:
                self._save(f"model_{epoch:07d}", state)
        self._save("model_final", state)
        return state

    def train_resident(self, scenes, state: TrainState, epochs: int,
                       seed: int = 0, chunk: int = 100,
                       checkpoint_every_chunks: int = 10):
        """Device-resident training (JAX trainer.py:380-500): every scene
        is packed ONCE on the host with its backward books (the C++
        packer, data/native_packer.pack_pyramid_native(..., backward=
        True)) and kept on the device as a dict of tensors; then
        ``epochs`` shuffled passes run as chunks of ``chunk`` packed
        steps (:meth:`scan`), one host fetch a chunk. The order is JAX's:
        a ``default_rng(seed + 77)`` permutation per epoch, cycle-padded
        to a chunk multiple. Chunk c's sampler draws come from
        :func:`chunk_generator` (seed, c).

        No eval-in-train or strike culling on this path; a non-finite
        step is skipped by the device gate and counted. ``model_min_loss``
        is saved on a better chunk mean, ``model_resident_last`` every
        ``checkpoint_every_chunks`` chunks. Resume: a ``state`` whose
        ``step`` is a chunk multiple continues at that chunk; any other
        step raises ValueError. ``self.history`` holds one (total,
        losses, ok, seconds) per step run, the seconds its chunk's
        mean; ``resident_bytes``, ``pack_seconds``, ``resident_order``
        (every step's scene index) and ``resident_skipped`` (non-finite
        steps) describe the run."""
        from detection_3d_tpu_torch.data.native_packer import (
            pack_pyramid_native)
        from detection_3d_tpu_torch.data.packing import to_device
        if self.mesh is not None:
            raise NotImplementedError(
                "train_resident runs on one device; train over a mesh with "
                "train()")
        scenes = list(scenes)
        n = len(scenes)
        start_step = int(state.step)
        if start_step % chunk:
            raise ValueError(
                f"resume step {start_step} is not a multiple of the chunk "
                f"size {chunk}: resume from a model_resident_last "
                "checkpoint (saved at chunk boundaries)")
        t0 = time.perf_counter()
        data = [to_device(pack_pyramid_native(self.cfg, s, backward=True),
                          self.device) for s in scenes]
        self.resident_bytes = sum(t.numel() * t.element_size()
                                  for d in data for t in d.values())
        self.pack_seconds = time.perf_counter() - t0
        if self.logger:
            self.logger.info(
                "train_resident: packed %d scenes in %.1fs (%.0f MB "
                "resident)", n, self.pack_seconds, self.resident_bytes / 1e6)

        shuffle_rng = np.random.default_rng(seed + 77)
        total_steps = epochs * n
        order = [int(i) for _ in range(epochs)
                 for i in shuffle_rng.permutation(n)]
        # cycle_pad also when the pad exceeds the order (4 scenes x 10
        # epochs, chunk 100)
        order = cycle_pad(order, chunk)
        n_chunks = len(order) // chunk
        if self.logger and len(order) > total_steps:
            self.logger.info(
                "train_resident: padded %d -> %d steps (chunk %d); the extra "
                "%d steps cycle the shuffled order", total_steps, len(order),
                chunk, len(order) - total_steps)
        start_chunk = start_step // chunk
        if self.logger and start_chunk:
            self.logger.info("train_resident: resuming at step %d (chunk "
                             "%d/%d)", start_step, start_chunk, n_chunks)
        state.model.train()
        self.history = []
        self.resident_order = order
        skipped = 0
        t_run = time.perf_counter()
        for c in range(start_chunk, n_chunks):
            gen = chunk_generator(seed, c, self.device)
            idxs = order[c * chunk:(c + 1) * chunk]
            t_chunk = time.perf_counter()
            results = self.scan(state, [data[i] for i in idxs], gen,
                                packed="pyramid")
            dt = (time.perf_counter() - t_chunk) / chunk
            totals = np.array([r[0] for r in results])
            oks = np.array([r[2] for r in results])
            self.history += [(total, losses, ok, dt)
                             for total, losses, ok, _ in results]
            for total, losses, _, _ in results:
                self.meters.update(loss=total, time=dt, **losses)
            skipped += int((~oks).sum())
            mean_loss = float(np.mean(totals[oks])) if oks.any() else \
                float("nan")
            done = (c + 1) * chunk
            if self.logger:
                ran = done - start_step
                eta = (time.perf_counter() - t_run) / ran * \
                    max(total_steps - done, 0)
                shown = min(done, total_steps)
                self.logger.info(
                    "resident step %d/%d epoch %d loss %.4f (chunk mean "
                    "%.4f) time %.4fs/step eta %.0fs%s", shown, total_steps,
                    shown // n, totals[-1], mean_loss, dt, eta,
                    f" SKIPPED {skipped} non-finite" if skipped else "")
            if np.isfinite(mean_loss) and mean_loss < self.min_loss:
                self.min_loss = mean_loss
                self._save("model_min_loss", state)
            if (c + 1) % checkpoint_every_chunks == 0:
                self._save("model_resident_last", state)
        self.resident_skipped = skipped
        if self.logger:
            ran = max(n_chunks * chunk - start_step, 1)
            secs = time.perf_counter() - t_run
            self.logger.info("train_resident: %d steps in %.1fs (%.4fs/step)",
                             ran, secs, secs / ran)
        return state

    def _evaluate_epoch(self, epoch, preds, gts):
        """Evaluate an epoch's train-time detections on the trainer's
        device into ``self.last_train_eval`` and log the summary."""
        cfg = self.cfg
        self.last_train_eval = evaluate_detections(
            preds, gts, cfg.num_classes, cfg.test.iou_threshold,
            eval_aug_thickness=eval_aug_thickness(cfg),
            class_names=cfg.ordered_class_names(), device=self.device)
        if self.logger:
            self.logger.info("eval-in-train epoch %d:\n%s", epoch,
                             self.last_train_eval.summary())

    def _strike(self, si, name, strikes, culled, culled_names, n_scenes, it):
        """Count a non-finite step against scene ``si``; cull it from the
        rotation at ``bad_scene_strikes`` and persist the list."""
        if self.logger:
            self.logger.warning("non-finite loss at iter %d; update "
                                "skipped", it)
        strikes[si] += 1
        if strikes[si] < self.bad_scene_strikes or si in culled:
            return
        culled.add(si)
        culled_names.append(name)
        self._persist_bad_scenes(culled_names)
        if self.logger:
            self.logger.warning(
                "scene %s culled after %d non-finite steps (%d/%d scenes "
                "culled)", name, strikes[si], len(culled), n_scenes)
