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
"""

from __future__ import annotations

from typing import Sequence

import torch

from detection_3d_tpu_torch.config.defaults import Config


def warmup_multistep_schedule(base_lr: float, warmup_factor: float,
                              warmup_iters: int, warmup_method: str,
                              milestones: Sequence[int], gamma: float):
    """step -> lr, in float32 as the JAX schedule computes it."""
    milestones = tuple(sorted(milestones))
    f32 = torch.float32

    def schedule(step):
        step = torch.tensor(float(step), dtype=f32)
        if warmup_method == "linear" and warmup_iters > 0:
            alpha = torch.clamp(step / max(warmup_iters, 1), 0.0, 1.0)
            wf = warmup_factor * (1.0 - alpha) + alpha
        elif warmup_method == "constant" and warmup_iters > 0:
            wf = torch.where(step < warmup_iters, warmup_factor, 1.0)
        else:
            wf = torch.tensor(1.0, dtype=f32)
        k = float(sum(float(step) >= m for m in milestones))
        return float(base_lr * wf * torch.tensor(gamma, dtype=f32) ** k)

    return schedule


def is_bias(name: str) -> bool:
    last = name.rsplit(".", 1)[-1]
    return last == "bias" or last.endswith("_b")


class Solver:
    """SGD over two parameter groups (weights, biases) under the warmup
    multistep schedule, with the schedule's clock in ``count``."""

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
        self.count = 0

    def lr(self, step: int) -> float:
        return self.base_lr * self.sched(step)

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def apply(self):
        """One update from the gradients on the parameters (None counts
        as zero), at the schedule's current clock; advances the clock."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.optimizer.param_groups:
            # f32 product, as optax's -base_lr * factor * sched(count)
            group["lr"] = float(torch.tensor(
                self.base_lr * group["lr_factor"], dtype=torch.float32)
                * self.sched(self.count))
        self.optimizer.step()
        self.count += 1

    def state_dict(self):
        return {"optimizer": self.optimizer.state_dict(),
                "count": self.count}

    def load_state_dict(self, state):
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])
