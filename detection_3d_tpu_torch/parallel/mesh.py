"""The device mesh, data-parallel training steps and the rank launcher.

Counterpart of detection_3d_tpu/parallel/mesh.py over
``torch.distributed``, one process per rank:

  * :class:`Mesh` names the process groups of a 1-D (``dp`` or ``sp``)
    or 2-D (``dp`` x ``sp``) layout of the ranks, and the device each rank
    runs on: its own card under NCCL, a shared card (or the CPU) under
    gloo. The backend is always the caller's choice; NCCL with fewer
    cards than ranks raises;
  * :func:`batched_train_step` is JAX's sharded step: each rank runs its
    share of the step's buildings one after another (forward and
    backward, the loss scaled by 1 / buildings), then ONE all-reduce of a
    flat buffer of the loss sums and every parameter's gradient (zeros
    where a parameter got none), in one fixed order on every rank; the
    NaN gate reads the reduced buffer, so every rank commits or skips
    alike. BN statistics stay per building, as JAX's vmap keeps them;
  * :func:`all_gather_results` gathers per-rank evaluation results;
  * :func:`launch` spawns ``world_size`` rank processes that meet
    through a ``file://`` rendezvous (no TCP port), runs a function in
    each and returns the results in rank order. The tests and
    chip_smoke.py start their ranks with it; ``torchrun`` starts the
    CLI's.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.parallel.collectives import _gather


@dataclass
class Mesh:
    """The ranks laid out as ``shape`` over ``axes`` (rank = row-major
    index, as JAX's ``devices.reshape(shape)``). ``groups[axis]`` is the
    process group of this rank's line along ``axis`` (the default group
    when the axis spans every rank); ``coords[axis]`` its index on that
    line."""
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    world_size: int
    device: torch.device
    backend: str
    groups: Dict[str, Any] = field(default_factory=dict)
    coords: Dict[str, int] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def rank_device(backend: str, device="cuda") -> torch.device:
    """The device of this rank: the CPU when asked for; under NCCL card
    ``LOCAL_RANK`` (raises unless there is one card per rank of this
    host); under gloo on the card, ranks share the host's cards
    round-robin (all on ``cuda:0`` with one card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on cards only: use gloo on the CPU")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (with the gloo "
            "backend) to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK") or dist.get_rank())
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE")
                     or dist.get_world_size())
    cards = torch.cuda.device_count()
    if backend == "nccl" and cards < local_size:
        raise RuntimeError(
            f"nccl needs one card per rank: {local_size} ranks, {cards} "
            "card(s); use the gloo backend to share cards")
    dev = torch.device("cuda", local % cards)
    torch.cuda.set_device(dev)
    return dev


def make_mesh(n: Optional[int] = None, axis: str = "dp",
              backend: Optional[str] = None, device="cuda") -> Mesh:
    """A 1-D mesh over the ``n`` ranks of the default process group
    (every rank when None), joined with ``backend`` from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``_PORT``)
    when not joined yet."""
    if not dist.is_initialized():
        if backend is None:
            raise ValueError("make_mesh: the process group is not "
                             "initialised; name a backend")
        dist.init_process_group(backend, init_method="env://")
    world = dist.get_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"make_mesh: {n} ranks asked, {world} in the "
                         "process group")
    be = dist.get_backend()
    if backend is not None and backend != be:
        raise ValueError(f"make_mesh: backend {backend!r} asked, the "
                         f"group runs {be!r}")
    rank = dist.get_rank()
    return Mesh((axis,), (n,), rank, world, rank_device(be, device), be,
                {axis: dist.group.WORLD}, {axis: rank})


def make_mesh_2d(n_dp: int, n_sp: int, backend: Optional[str] = None,
                 device="cuda") -> Mesh:
    """A (dp, sp) mesh: rank = d * n_sp + s. Each rank's ``sp`` group
    holds the n_sp ranks of its dp row (one building's shards), its
    ``dp`` group the n_dp ranks with its shard index. Every rank creates
    every group, in one order, as ``new_group`` requires."""
    mesh = make_mesh(n_dp * n_sp, "dp", backend, device)
    d, s = divmod(mesh.rank, n_sp)
    groups = {}
    for row in range(n_dp):
        g = dist.new_group([row * n_sp + j for j in range(n_sp)])
        if row == d:
            groups["sp"] = g
    for col in range(n_sp):
        g = dist.new_group([i * n_sp + col for i in range(n_dp)])
        if col == s:
            groups["dp"] = g
    return Mesh(("dp", "sp"), (n_dp, n_sp), mesh.rank, mesh.world_size,
                mesh.device, mesh.backend, groups, {"dp": d, "sp": s})


def dp_batch_size(ims_per_batch: int, dp: int) -> int:
    """Buildings a data-parallel step takes: ``max(ims_per_batch, dp)``
    rounded up to a multiple of ``dp`` (JAX trainer.py:516-525,
    tools/train_net.py:76-88)."""
    bsz = max(ims_per_batch, dp)
    return bsz + (-bsz) % dp


def rank_generator(seed: int, dp_rank: int, device) -> torch.Generator:
    """The samplers' generator of one data-parallel rank, seeded from
    (seed, dp_rank): ranks draw apart (JAX folds the dp index into the
    key), and the shards of one dp group, which share a dp_rank, draw
    alike, as spatial sharding's replicated heads need."""
    words = np.random.SeedSequence((seed + 123, dp_rank)).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(words[0]) << 32 | int(words[1]))


def flat_grads(params) -> torch.Tensor:
    """Every parameter's gradient in one f32 buffer, in parameter order,
    zeros where a parameter has none."""
    return torch.cat([
        (p.grad.reshape(-1).to(torch.float32) if p.grad is not None
         else torch.zeros(p.numel(), dtype=torch.float32, device=p.device))
        for p in params])


def set_flat_grads(params, flat: torch.Tensor):
    """Write ``flat`` (as :func:`flat_grads` lays it out) back as every
    parameter's gradient."""
    at = 0
    for p in params:
        n = p.numel()
        p.grad = flat[at:at + n].view_as(p).to(p.dtype)
        at += n


def reduce_step(params, stats: torch.Tensor, group=None):
    """ONE all-reduce (sum) of ``stats`` (the loss sums, scaled as the
    caller wants) and every gradient, written back to the parameters.
    Returns (reduced stats, ok): ok is the NaN gate over the reduced
    buffer, the same on every rank."""
    flat = torch.cat([stats.to(torch.float32), flat_grads(params)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    n = stats.numel()
    set_flat_grads(params, flat[n:])
    return flat[:n], torch.isfinite(flat).all()


def batched_train_step(cfg: Config, model, solver, mesh: Mesh):
    """The data-parallel step over ``mesh``'s ``dp`` axis (JAX
    parallel/mesh.py:51, engine/trainer.py:258-330).

    Returns ``step(batches, generator=None, priorities=None) -> (total,
    losses, ok, true_num, dets)``: ``batches`` are this rank's padded
    buildings (data/packing.pad_scene dicts; every rank the same
    number), ``priorities`` optionally one sampler-draw dict per building
    (else the draws come from ``generator``). total and losses are the
    means over the step's buildings on every rank, true_num the largest
    over them, all as device tensors; ``dets`` with
    ``cfg.eval_in_train`` is a (buildings, K, 10) tensor of every
    building's train-time detections ``[boxes7 | score | label |
    valid]`` in batch order (rank-major), else None. The update is
    applied only where the reduced loss and gradients are finite."""
    from detection_3d_tpu_torch.engine.trainer import (
        pack_detections, total_loss)

    group, n_dp = mesh.group("dp"), mesh.size("dp")

    def step(batches, generator=None, priorities=None):
        bsz = len(batches) * n_dp
        solver.zero_grad()
        sums, tns, dets = None, [], []
        for i, batch in enumerate(batches):
            losses, det, true_num = model.training_losses(
                cfg, batch, mesh.device, generator,
                None if priorities is None else priorities[i])
            if det is not None:
                dets.append(pack_detections(det))
            total = total_loss(losses)
            (total / bsz).backward()
            names = sorted(losses)
            row = torch.stack([total.detach()]
                              + [losses[k].detach() for k in names])
            sums = row if sums is None else sums + row
            tns.append(true_num)
        reduced, ok = reduce_step(solver.params, sums / bsz, group)
        solver.apply(ok)
        tn = torch.stack(tns).max().to(torch.int64)
        dist.all_reduce(tn, op=dist.ReduceOp.MAX, group=group)
        gathered = None
        if dets:
            gathered = torch.cat(_gather(torch.stack(dets), group), 0)
        return (reduced[0], dict(zip(names, reduced[1:])), ok, tn,
                gathered)

    return step


def all_gather_results(local_results, group=None) -> List:
    """Every rank's ``local_results`` (any picklable object), in rank
    order; ``[local_results]`` without a process group of more than one
    rank (JAX parallel/mesh.py:91-97)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return [local_results]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, local_results, group=group)
    return out


# ---- the rank launcher -----------------------------------------------------


def _to_host(obj):
    """Tensors in a result tree as numpy arrays (a result crosses the
    process boundary by value; a tensor would be sent as shared memory
    that dies with the rank)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world_size, backend, init_file, args, results,
               cpu_threads):
    if cpu_threads:
        torch.set_num_threads(cpu_threads)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    try:
        # NCCL binds each rank to its card (rank_device's mapping)
        device_id = torch.device("cuda", rank % torch.cuda.device_count()) \
            if backend == "nccl" else None
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world_size, rank=rank,
                                device_id=device_id)
        out = _to_host(fn(*args))
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, then the rank exits
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, backend: str, init_file: str,
           args: Sequence = (), timeout: float = 900.0,
           cpu_threads: int = 1) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` spawned rank processes joined
    in one process group (``backend``, ``file://init_file``: a path no
    other launch uses, whose file does not exist yet) and return their
    results in rank order, tensors as numpy arrays.

    ``fn`` must be importable by name (a module-level function of this
    package, not of a test file). Each rank sets ``cpu_threads`` torch
    threads (0 leaves the default). Raises RuntimeError, after stopping
    every rank, when a rank raises, exits without a result or the
    ranks outlast ``timeout`` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, init_file,
                               tuple(args), results, cpu_threads))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    errors: List[str] = []
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead and results.empty():
                    time.sleep(1.0)       # a last result may be in flight
                    if results.empty():
                        errors.append(f"ranks {dead} exited with codes "
                                      f"{[procs[r].exitcode for r in dead]}"
                                      " before reporting")
                        break
                if time.monotonic() > deadline:
                    errors.append(f"timed out after {timeout} s")
                    break
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank} failed:\n{out}")
                break
    finally:
        if errors:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("launch: " + "\n".join(errors))
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"launch: ranks exited non-zero: {bad}")
    return [got[r] for r in range(world_size)]
