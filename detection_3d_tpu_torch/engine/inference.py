"""Inference engine: per-building and batched predict, and the serving loop.

Counterpart of detection_3d_tpu/engine/inference.py. A predict takes one
building in one of four input forms (``packed``) and gives one packed
(K, 10) f32 array ``[boxes7 | score | label | valid]`` plus the input
layer's ``true_num``:

  False     — the raw padded f32 arrays of :func:`pad_scene`;
  True      — quantized points (data/packing.pack_scene), voxelized on
              the device;
  "table"   — the host-built voxel table (data/packing.pack_table);
  "pyramid" — the host-built table and every pyramid table, rulebook
              and row order (data/pyramid_packing.pack_pyramid): the
              device runs no sort, scatter or search before the convs.

:func:`make_batch_predict_fn` answers a unit of B buildings with one
forward, as the JAX package's ``jax.vmap`` does: the dict of each form
stacked over B gives stacked tables and flat books (ops/sparse.py), each
kernel launches once a unit, and building b's detections are what it
gives alone. :func:`make_predict_fn` runs the same code on one building.

On the card both predicts replay CUDA graphs (:class:`GraphedForward`):
the first call of an input signature (:func:`graph_signature`) runs
eagerly, the second captures the forward from the inputs on the device
to the packed detections, and every later call copies its inputs into
the graph's own buffers and replays it. The same kernels run in the same
order on the same data; only the host's launches go. On the CPU, or with
``graph=False``, every call runs eagerly.

:func:`run_inference` answers a list of buildings one after another
(raw form), or pipelined: worker threads pack and copy unit i+1.. to
the card while it runs unit i (see :func:`run_inference`).
``run_inference(evaluate=True)`` scores the detections with
evaluation/detection_eval.py.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.data.native_packer import (
    pack_pyramid_native, pack_table_native,
)
from detection_3d_tpu_torch.data.packing import (
    pad_scene, to_device, unpack_batch, unpack_table,
)
from detection_3d_tpu_torch.data.pyramid_packing import unpack_pyramid
from detection_3d_tpu_torch.engine.trainer import (
    pack_detections, unpack_detections)
from detection_3d_tpu_torch.evaluation.detection_eval import (
    eval_aug_thickness, evaluate_detections,
)
from detection_3d_tpu_torch.models.detector import SparseRCNN, voxelize_points
from detection_3d_tpu_torch.utils.device import resolve_device
from detection_3d_tpu_torch.utils.profiling import span

_LOG = logging.getLogger(__name__)

PACK_FNS = {"pyramid": pack_pyramid_native, "table": pack_table_native}


RAW_KEYS = ("points", "feats", "points_valid")


def _inputs(packed, batch) -> Dict[str, torch.Tensor]:
    """The arrays of ``batch`` the forward reads, as tensors where they
    are (numpy arrays on the host, without a copy)."""
    keys = RAW_KEYS if not packed else batch
    return {k: torch.as_tensor(batch[k]) for k in keys}


def _input_layer(cfg, packed, inputs):
    """The scale-0 table (and the host-built pyramid, or None) from the
    inputs on the device: unpack or voxelize."""
    if not packed:
        return voxelize_points(cfg, *(inputs[k] for k in RAW_KEYS)), None
    if packed == "pyramid":
        pyramid = unpack_pyramid(cfg, inputs)
        return pyramid["tables"][0], pyramid
    if packed == "table":
        return unpack_table(cfg, inputs), None
    b = unpack_batch(cfg, inputs)
    return voxelize_points(cfg, *(b[k] for k in RAW_KEYS)), None


def _forward(model, table, pyramid):
    """The model on the input layer: (packed detections, true_num)."""
    det = model(table, pyramid=pyramid)
    return pack_detections(det), table.true_num


def _predict_one(cfg, model, packed, dev, batch, buildings):
    """One forward over ``batch`` (``buildings`` buildings) in the
    spans ``model.predict`` > ``model.input`` (to the device, unpack or
    voxelize), then the forward's stages."""
    with span("model.predict", buildings=buildings):
        with span("model.input"):
            inputs = {k: v.to(dev) for k, v in _inputs(packed, batch).items()}
            table, pyramid = _input_layer(cfg, packed, inputs)
        return _forward(model, table, pyramid)


def graph_signature(packed, inputs: Dict[str, torch.Tensor], model) -> tuple:
    """The key of a captured forward: the input form, each input's name,
    shape and dtype, and the storage of each of the model's parameters
    and buffers. A graph reads its tensors at the addresses it was
    captured with, so a weight updated in place needs no new capture and
    a weight rebound to new storage does."""
    return (packed,
            tuple((k, tuple(v.shape), v.dtype)
                  for k, v in sorted(inputs.items())),
            tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                        model.buffers())))


class _CaptureGate:
    """Keeps the pack workers' host->device copies (:class:`_DeviceCopies`)
    and a graph's capture apart in time: torch refuses a copy from
    pageable host memory while a CUDA graph captures, on any thread.
    Copies pass together; a capture waits for those under way, and a
    copy that comes while a capture waits or runs waits for its end."""

    def __init__(self):
        self._cond = threading.Condition()
        self._copies = 0
        self._captures = 0      # waiting or running

    @contextmanager
    def copy(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._captures)
            self._copies += 1
        try:
            yield
        finally:
            with self._cond:
                self._copies -= 1
                self._cond.notify_all()

    @contextmanager
    def capture(self):
        with self._cond:
            self._captures += 1
            self._cond.wait_for(lambda: not self._copies)
        try:
            yield
        finally:
            with self._cond:
                self._captures -= 1
                self._cond.notify_all()


_GATE = _CaptureGate()


class _Captured:
    """One input signature's forward as a CUDA graph: the static input
    buffers it reads and the static outputs it writes."""

    def __init__(self, cfg, model, packed, inputs, dev, pool):
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                       for k, v in inputs.items()}
        self.load(inputs)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the pack workers go on packing on their threads
        with _GATE.capture(), \
                torch.cuda.graph(self.graph, pool=pool,
                                 capture_error_mode="thread_local"):
            self.out, self.true_num = _forward(
                model, *_input_layer(cfg, packed, self.inputs))

    def load(self, inputs):
        """Copy a call's inputs into the static buffers, on the current
        stream (host arrays as the eager path copies them)."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)

    def replay(self):
        """Run the graph; its outputs cloned, so that they outlive the
        next replay."""
        self.graph.replay()
        return self.out.clone(), self.true_num.clone()


class GraphedForward:
    """A predict's forward on the card as a CUDA graph (module
    docstring), of the last :func:`graph_signature` it was called with.
    The first call of an input form and shapes runs eagerly (it builds
    the kernel libraries and fills utils/device.device_constant's
    cache); a later call whose signature is not the graph's captures a
    new graph in its place (the second call, or the first after a weight
    was rebound) and replays it, and the calls after replay. A replayed
    call runs in ``model.predict`` > ``model.input`` (the copies into the
    graph's buffers), ``model.replay``; a capturing call in
    ``model.predict`` > ``model.capture`` (the copies and the capture,
    whose stage spans log no device work), ``model.replay``; the
    forward's stage spans show its work on eager calls only. A capture
    calls the kernel wrappers (ops/cuda_lib.launches counts it), a
    replay calls none: ``replays`` counts them. Every graph draws on one
    memory pool. A capture that fails raises."""

    def __init__(self, cfg, model, packed, dev):
        self.cfg, self.model, self.packed, self.dev = cfg, model, packed, dev
        self.pool = torch.cuda.graph_pool_handle()
        self.key: Optional[tuple] = None
        self.captured: Optional[_Captured] = None
        self.replays = 0
        self.warm = set()       # input parts of the signatures run eagerly

    def __call__(self, batch, buildings):
        inputs = _inputs(self.packed, batch)
        key = graph_signature(self.packed, inputs, self.model)
        fresh = key != self.key
        if fresh and key[:2] not in self.warm:
            self.warm.add(key[:2])
            return _predict_one(self.cfg, self.model, self.packed, self.dev,
                                batch, buildings)
        # a graph captures and replays on the current device's streams
        with torch.cuda.device(self.dev), \
                span("model.predict", buildings=buildings):
            if fresh:
                with span("model.capture"):
                    self.key, self.captured = None, None    # frees the old
                    self.captured = _Captured(
                        self.cfg, self.model, self.packed, inputs, self.dev,
                        self.pool)
                    self.key = key
            else:
                with span("model.input"):
                    self.captured.load(inputs)
            with span("model.replay", buildings=buildings):
                self.replays += 1
                return self.captured.replay()


def _model_on(cfg, model, dev):
    return (model if model is not None else SparseRCNN(cfg)).to(dev).eval()


def _make(cfg, model, device, packed, graph, count):
    """predict(batch), counting ``count(batch)`` buildings a call; on the
    card with ``graph`` through a :class:`GraphedForward`, kept as
    ``predict.graphed`` (None otherwise)."""
    dev = resolve_device(device)
    model = _model_on(cfg, model, dev)
    graphed = GraphedForward(cfg, model, packed, dev) \
        if graph and dev.type == "cuda" else None

    @torch.inference_mode()
    def predict(batch):
        if graphed is not None:
            return graphed(batch, count(batch))
        return _predict_one(cfg, model, packed, dev, batch, count(batch))

    predict.graphed = graphed
    return predict


def make_predict_fn(cfg: Config, model: Optional[SparseRCNN] = None,
                    device="cuda", packed=False, graph: bool = True):
    """Per-building predict on ``device`` (the card unless the caller
    asks for the CPU; raises when CUDA is asked for and absent).

    Returns ``predict(batch) -> (packed_out, true_num)``:
    ``batch`` is a dict of the input form ``packed`` (module docstring),
    as numpy arrays or as tensors already on ``device``; ``packed_out``
    is a (K, 10) f32 tensor ``[boxes7 | score | label | valid]`` and
    ``true_num`` the pre-truncation voxel count, both on ``device``.
    On the card, ``graph`` replays the forward as CUDA graphs
    (:class:`GraphedForward`); ``False`` runs every call eagerly, in the
    forward's stage spans.
    """
    if packed not in (False, True, "table", "pyramid"):
        raise ValueError(
            f"packed={packed!r}: expected False, True, 'table' or "
            "'pyramid'")
    return _make(cfg, model, device, packed, graph, lambda batch: 1)


def make_batch_predict_fn(cfg: Config, model: Optional[SparseRCNN] = None,
                          device="cuda", packed="table", graph: bool = True):
    """Multi-building predict: ``predict(stacked) -> ((B, K, 10), (B,))``
    over a packed dict whose every array is stacked on a leading axis B
    (``np.stack`` per key over pack_table / pack_pyramid / pack_scene
    outputs): one forward over the unit (the JAX package's vmap), whose
    building b gives what it gives alone. Nothing waits for the card
    before the outputs are fetched. ``graph`` as in
    :func:`make_predict_fn`."""
    if packed not in (True, "table", "pyramid"):
        raise ValueError(
            f"packed={packed!r}: expected True, 'table' or 'pyramid'")
    return _make(cfg, model, device, packed, graph,
                 lambda stacked: len(next(iter(stacked.values()))))


class _DeviceCopies:
    """Host->device copies made on the pack workers' threads. On the card
    each worker thread copies on a CUDA stream of its own, never while a
    graph captures (:class:`_CaptureGate`), and records an event; :meth:`take` makes the serving stream wait on that event and
    marks every tensor as used by it (``record_stream``), so the caching
    allocator cannot hand a block back to the copy stream while the
    serving stream still reads it. On the CPU the arrays become tensors
    without a copy."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self._local = threading.local()

    def put(self, host: Dict[str, np.ndarray]):
        if self.dev.type != "cuda":
            return to_device(host, self.dev), None
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.dev)
        with _GATE.copy(), torch.cuda.stream(stream):
            batch = to_device(host, self.dev)
            done = torch.cuda.Event()
            done.record(stream)
        return batch, done

    def take(self, item) -> Dict[str, torch.Tensor]:
        batch, done = item
        if done is not None:
            serving = torch.cuda.current_stream(self.dev)
            serving.wait_event(done)
            for t in batch.values():
                t.record_stream(serving)
        return batch


def _serve_pipelined(cfg, model, scenes, dev, predict_fn, pack_workers,
                     pack_mode, batch_size, record, tm):
    """The pipelined loop of :func:`run_inference`; returns (seconds of
    units 1.., buildings in them)."""
    pack_fn = PACK_FNS[pack_mode]
    B = batch_size
    units = [list(range(i, min(i + B, len(scenes))))
             for i in range(0, len(scenes), B)]
    if predict_fn is not None:
        predict = predict_fn
    elif B > 1:
        predict = make_batch_predict_fn(cfg, model, dev, packed=pack_mode)
    else:
        predict = make_predict_fn(cfg, model, dev, packed=pack_mode)
    copies = _DeviceCopies(dev)

    def pack_and_put(unit):
        with span("serve.pack"):
            packs = [pack_fn(cfg, scenes[j]) for j in unit]
            if B == 1:
                return copies.put(packs[0])
            packs += [packs[-1]] * (B - len(packs))   # pad the tail unit
            return copies.put({k: np.stack([p[k] for p in packs])
                               for k in packs[0]})

    def record_unit(unit, out):
        packed_out = out[0].cpu().numpy()
        true_num = out[1].cpu().numpy()
        if B == 1:
            record(unit[0], packed_out, int(true_num))
        else:
            for bi, si in enumerate(unit):
                record(si, packed_out[bi], int(true_num[bi]))

    total_t, n_timed = 0.0, 0
    pool = ThreadPoolExecutor(max_workers=pack_workers)
    q = deque()
    try:
        for j in range(min(pack_workers, len(units))):
            q.append(pool.submit(pack_and_put, units[j]))
        pending = None      # (unit, out) dispatched but not yet fetched
        for i, unit in enumerate(units):
            with span("serve.unit", buildings=len(unit)):
                if i + pack_workers < len(units):
                    q.append(pool.submit(pack_and_put,
                                         units[i + pack_workers]))
                t0 = time.perf_counter()
                with span("serve.wait_pack"):
                    batch = copies.take(q.popleft().result())
                t1 = time.perf_counter()
                with span("serve.dispatch"):
                    out = predict(batch)
                t2 = time.perf_counter()
                # double buffer: fetch unit i-1 while the card runs unit i
                with span("serve.fetch"):
                    if pending is not None:
                        record_unit(*pending)
                    pending = (unit, out)
                t3 = time.perf_counter()
            tm["wait_pack"] += t1 - t0
            tm["dispatch"] += t2 - t1
            tm["drain_fetch"] += t3 - t2
            if i > 0:   # unit 0 warms up allocator, kernels and workers
                total_t += t3 - t0
                n_timed += len(unit)
        if pending is not None:
            t0 = time.perf_counter()
            with span("serve.fetch"):
                record_unit(*pending)
            dt = time.perf_counter() - t0
            tm["drain_fetch"] += dt
            if len(units) > 1:
                total_t += dt
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return total_t, n_timed


def run_inference(cfg: Config, model: Optional[SparseRCNN],
                  scenes: Iterable[Dict], device="cuda",
                  evaluate: bool = False, predict_fn=None, logger=None,
                  pipelined: bool = False, pack_workers: int = 2,
                  pack_mode: str = "pyramid",
                  timings: Optional[Dict[str, float]] = None,
                  batch_size: int = 1):
    """Answer a list of buildings.

    Returns (predictions, result, seconds_per_building): one
    {"boxes", "scores", "labels", "true_num"} dict per building (numpy,
    valid rows only). With ``evaluate`` (off by default, unlike the JAX
    package's run_inference), ``result`` is the DetectionEvalResult of
    the detections against the scenes' ``gt_boxes``/``gt_labels``, its
    IoUs computed on ``device`` after the timed loop; else None.
    ``logger`` gets the capacity warnings and, with ``evaluate``, the
    summary.

    Without ``pipelined`` the buildings go one after another in the raw
    form; the time is the host clock from the padded arrays to the
    detections on the host, averaged over every building after the
    first. ``batch_size`` > 1 raises ValueError there.

    With ``pipelined`` the serving fast path runs: ``pack_workers``
    threads pack units (of ``batch_size`` buildings) with the C++ packer
    and copy them to the card (data/native_packer.py; ``pack_mode``
    "pyramid" builds every table and rulebook on the host, "table" only
    the input layer) while the card runs the current unit; and the
    detections of unit i-1 are fetched after unit i is dispatched
    (double buffering). With ``batch_size`` > 1 a unit is
    :func:`make_batch_predict_fn`'s stacked dict, the tail unit padded
    by repeating its last building. ``predict_fn`` replaces the
    predict of that form. The time is the host clock per building over
    units 1.. (unit 0 warms up). With nothing timed (one building, or
    one unit) the time is NaN and a warning is logged. ``timings``, when given, receives the
    summed seconds of ``wait_pack`` (pack and copy not hidden),
    ``dispatch`` (the predict call) and ``drain_fetch`` (the previous
    unit's detections to the host). Each unit runs in the span
    ``serve.unit`` around ``serve.wait_pack``, ``serve.dispatch`` and
    ``serve.fetch``, on the brackets ``timings`` sums (the last fetch
    after the loop in a ``serve.fetch`` of its own), and each pack in
    ``serve.pack`` on its worker's thread (utils/profiling.span).
    """
    if pack_mode not in PACK_FNS:
        raise ValueError(
            f"pack_mode={pack_mode!r}: expected 'pyramid' or 'table'")
    if pack_workers < 1 or batch_size < 1:
        raise ValueError("pack_workers and batch_size must be >= 1")
    if batch_size > 1 and not pipelined:
        raise ValueError(f"batch_size={batch_size} needs pipelined=True: "
                         "the sequential loop serves one building at a "
                         "time")
    log = logger or _LOG
    scenes = list(scenes)
    cap0 = cfg.caps.scale_caps(cfg.sparse3d.num_scales)[0]
    preds: list = [None] * len(scenes)

    def record(i, packed_out, true_num):
        if true_num > cap0:
            log.warning(
                "scene %d: %d voxels exceed the scale-0 capacity %d — "
                "input subsampled (raise caps.voxel_caps / max_points)",
                i, true_num, cap0)
        preds[i] = {**unpack_detections(packed_out), "true_num": true_num}

    if pipelined:
        dev = resolve_device(device)
        tm = {"wait_pack": 0.0, "dispatch": 0.0, "drain_fetch": 0.0}
        total_t, n_timed = _serve_pipelined(
            cfg, model, scenes, dev, predict_fn, pack_workers, pack_mode,
            batch_size, record, tm)
        if timings is not None:
            timings.update(tm)
    else:
        predict = predict_fn or make_predict_fn(cfg, model, device)
        total_t, n_timed = 0.0, 0
        for i, scene in enumerate(scenes):
            batch = pad_scene(cfg, scene)
            t0 = time.perf_counter()
            packed_out, true_num = predict(batch)
            a = packed_out.cpu().numpy()
            true_num = int(true_num)
            dt = time.perf_counter() - t0
            if i > 0:    # the first building warms up allocator and kernels
                total_t += dt
                n_timed += 1
            record(i, a, true_num)
    if n_timed:
        sec_per_building = total_t / n_timed
    else:
        sec_per_building = float("nan")
        log.warning("no building was timed (the first %s warms up): "
                    "s/building is NaN", "unit" if pipelined else "building")
    result = None
    if evaluate:
        gts = [{"boxes": s["gt_boxes"], "labels": s["gt_labels"]}
               for s in scenes]
        result = evaluate_detections(
            preds, gts, cfg.num_classes, cfg.test.iou_threshold,
            eval_aug_thickness=eval_aug_thickness(cfg),
            class_names=cfg.ordered_class_names(), device=device)
        if logger:
            logger.info("\n%s", result.summary())
            logger.info("sec/building: %.3f", sec_per_building)
    return preds, result, sec_per_building
