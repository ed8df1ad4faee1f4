"""Optimizer and LR schedule.

Counterpart of detection_3d_tpu/engine/solver.py (reference
solver/build.py:7-36, solver/lr_scheduler.py:10-52):
  * SGD with momentum; a parameter is a bias when the last part of its
    dotted name is ``bias`` or ends in ``_b``, and biases get lr x
    bias_lr_factor and weight_decay_bias;
  * WarmupMultiStep: linear (or constant) warmup over min(500,
    warmup_epochs x iters_per_epoch) iterations from warmup_factor to 1,
    then gamma^k decay at epoch-derived milestones.

Two rules keep a step equal to the JAX package's optax chain:
  * every parameter takes part in every update: one that the forward
    did not use (a decoder level below the deepest map a head reads)
    gets a zero gradient, so weight decay and momentum still move it;
  * the schedule's clock counts APPLIED updates only: a step skipped for
    a non-finite loss leaves the parameters, the momentum and the clock
    as they were, as the JAX trainer keeps the whole optax state.

The update runs on the parameters' device with no host sync: the clock
is a device tensor, the learning rate is computed from it there, and
``apply(ok)`` commits the new parameters and momentum only where the
device bool ``ok`` holds (the NaN gate of ``scan_steps`` and
``train_resident``). The momentum buffers start at zero, as optax's
trace does, so a gated first step has buffers to keep.
"""

from __future__ import annotations

from typing import Sequence

import torch

from detection_3d_tpu_torch.config.defaults import Config


def warmup_multistep_schedule(base_lr: float, warmup_factor: float,
                              warmup_iters: int, warmup_method: str,
                              milestones: Sequence[int], gamma: float):
    """step (a tensor) -> lr (an f32 tensor on the step's device), in
    float32 as the JAX schedule computes it."""
    milestones = tuple(sorted(milestones))
    f32 = torch.float32

    def schedule(step):
        step = torch.as_tensor(step).to(f32)
        if warmup_method == "linear" and warmup_iters > 0:
            alpha = torch.clamp(step / max(warmup_iters, 1), 0.0, 1.0)
            wf = warmup_factor * (1.0 - alpha) + alpha
        elif warmup_method == "constant" and warmup_iters > 0:
            wf = torch.where(step < warmup_iters, warmup_factor, 1.0).to(f32)
        else:
            wf = torch.ones_like(step)
        k = torch.zeros_like(step)
        for m in milestones:
            k = k + (step >= m).to(f32)
        return base_lr * wf * torch.full_like(step, gamma) ** k

    return schedule


def is_bias(name: str) -> bool:
    last = name.rsplit(".", 1)[-1]
    return last == "bias" or last.endswith("_b")


class Solver:
    """SGD with momentum over two parameter groups (weights, biases)
    under the warmup multistep schedule; :meth:`apply` makes the update,
    gated on the device. The schedule's clock is ``count``.
    ``optimizer`` (a torch.optim.SGD whose ``step()`` is never called)
    is kept only as the container of the groups' hyperparameters and the
    momentum buffers, because its state dict is the checkpoint's format;
    its ``lr`` records the base rate."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 iters_per_epoch: int = 1):
        s = cfg.solver
        warmup_iters = min(500, int(s.warmup_epochs * iters_per_epoch))
        milestones = [int(e * iters_per_epoch) for e in s.lr_step_epochs]
        self.sched = warmup_multistep_schedule(
            1.0, s.warmup_factor, warmup_iters, s.warmup_method, milestones,
            s.gamma)
        self.base_lr = s.base_lr
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        weights = [p for n, p in named if not is_bias(n)]
        biases = [p for n, p in named if is_bias(n)]
        self.optimizer = torch.optim.SGD(
            [{"params": weights, "weight_decay": s.weight_decay,
              "lr_factor": 1.0},
             {"params": biases, "weight_decay": s.weight_decay_bias,
              "lr_factor": s.bias_lr_factor}],
            lr=s.base_lr, momentum=s.momentum)
        self.device = self.params[0].device
        self._count = torch.zeros((), dtype=torch.int64, device=self.device)
        self._zero_missing_buffers()

    def _zero_missing_buffers(self):
        for p in self.params:
            st = self.optimizer.state[p]
            if st.get("momentum_buffer") is None:
                st["momentum_buffer"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)

    @property
    def count(self) -> int:
        """Applied updates so far (reads the device clock)."""
        return int(self._count)

    def lr(self, step: int) -> float:
        return float(self.base_lr * self.sched(torch.tensor(step)))

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def apply(self, ok=None):
        """One update from the gradients on the parameters (None counts
        as zero) at the clock's learning rate, committed to the
        parameters, the momentum and the clock only where ``ok`` (a bool
        tensor on the device, true when omitted) holds; nothing is read
        back to the host."""
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=self.device)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sched = self.sched(self._count)
        for group in self.optimizer.param_groups:
            ps = group["params"]
            if not ps:
                continue
            bufs = [self.optimizer.state[p]["momentum_buffer"] for p in ps]
            d = [p.grad for p in ps]
            if group["weight_decay"]:
                d = torch._foreach_add(d, ps, alpha=group["weight_decay"])
            new_bufs = torch._foreach_mul(bufs, group["momentum"])
            torch._foreach_add_(new_bufs, d)
            # f32 product, as optax's -base_lr * factor * sched(count): the
            # Python factor is rounded to f32 first (a scalar operand, so
            # no host-to-device copy, which would wait for the stream)
            neg_lr = -(sched * (self.base_lr * group["lr_factor"]))
            new_ps = torch._foreach_mul(new_bufs, neg_lr)
            torch._foreach_add_(new_ps, ps)
            for old, new in zip(bufs + ps, new_bufs + new_ps):
                torch.where(ok, new, old, out=old)
        self._count += ok.to(torch.int64)

    def state_dict(self):
        return {"optimizer": self.optimizer.state_dict(),
                "count": self.count}

    def load_state_dict(self, state):
        self.optimizer.load_state_dict(state["optimizer"])
        self._zero_missing_buffers()
        self._count.fill_(int(state["count"]))
