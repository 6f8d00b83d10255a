"""Learning-rate and momentum schedules as plain functions of the step
(counterpart of disprcnn_tpu/solver/schedules.py; reference
solver/lr_scheduler.py:65-239). Each returns a Python float; the JAX
schedules compute the same formulas in float32.

- warmup_multistep: linear (or constant) warmup over warmup_iters, then
  gamma^k at the milestones;
- one_cycle (fastai style, every shipped config): cosine anneal lr/25 ->
  lr over the first 30% of the steps, then lr -> lr / (25 * 1e4);
- one_cycle_momentum: momentum cycled inversely to one_cycle's rate;
- constant.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

Schedule = Callable[[int], float]


def annealing_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def warmup_multistep(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                     warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                     warmup_method: str = "linear") -> Schedule:
    milestones = sorted(steps)

    def schedule(step: int) -> float:
        wf = 1.0
        if step < warmup_iters:
            alpha = step / max(warmup_iters, 1)
            wf = warmup_factor * (1 - alpha) + alpha if warmup_method == "linear" \
                else warmup_factor
        return base_lr * wf * gamma ** sum(step >= m for m in milestones)

    return schedule


def _cycle(total_steps: int, pct_start: float, first: tuple, second: tuple) -> Schedule:
    """first = (start, peak) over the first pct_start of the steps, second =
    (peak, end) over the rest; step 0 is iteration 1."""
    step_up = float(total_steps * pct_start)
    step_down = float(total_steps - step_up)

    def schedule(step: int) -> float:
        it = step + 1.0
        if it / total_steps <= pct_start:
            return annealing_cos(*first, it / step_up)
        return annealing_cos(*second, (it - step_up) / step_down)

    return schedule


def one_cycle(max_lr: float, total_steps: int, pct_start: float = 0.3,
              div_factor: float = 25.0, final_div_factor: Optional[float] = None) -> Schedule:
    if final_div_factor is None:
        final_div_factor = div_factor * 1e4
    return _cycle(total_steps, pct_start, (max_lr / div_factor, max_lr),
                  (max_lr, max_lr / final_div_factor))


def one_cycle_momentum(total_steps: int, pct_start: float = 0.3, base_momentum: float = 0.85,
                       max_momentum: float = 0.95) -> Schedule:
    """max -> base momentum over the ramp-up, base -> max over the anneal
    (lr_scheduler.py:125-132, 218-227)."""
    return _cycle(total_steps, pct_start, (max_momentum, base_momentum),
                  (base_momentum, max_momentum))


def constant(base_lr: float) -> Schedule:
    return lambda step: base_lr


def make_schedule(scheduler: str, base_lr: float, max_iter: int = 0,
                  steps: Sequence[int] = (), gamma: float = 0.1,
                  warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                  warmup_method: str = "linear") -> Schedule:
    """The schedule that SOLVER.SCHEDULER names, from the SOLVER fields."""
    if scheduler == "WarmupMultiStepLR":
        return warmup_multistep(base_lr, steps, gamma, warmup_factor, warmup_iters,
                                warmup_method)
    if scheduler == "OneCycleScheduler":
        return one_cycle(base_lr, max_iter)
    if scheduler == "ConstantScheduler":
        return constant(base_lr)
    raise NotImplementedError(scheduler)


def make_momentum_schedule(scheduler: str, max_iter: int) -> Optional[Schedule]:
    """OneCycle cycles the momentum (cycle_momentum=True,
    lr_scheduler.py:131); None for the other schedulers."""
    return one_cycle_momentum(max_iter) if scheduler == "OneCycleScheduler" else None
