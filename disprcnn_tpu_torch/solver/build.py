"""The optimizer of the JAX package's solver (counterpart of
disprcnn_tpu/solver/build.py; reference solver/build.py:10-57) as a
``torch.optim.SGD`` over two parameter groups, with its rate and momentum
set from the schedules before every update.

The optax chain it matches, per parameter:
- weight decay added to the gradient before the momentum
  (``add_decayed_weights``): WEIGHT_DECAY for weights, WEIGHT_DECAY_BIAS
  for biases (every parameter named ``bias``, the BatchNorm shifts too);
- the momentum trace t = g + m * t (``optax.trace``), m from the momentum
  schedule when there is one (OneCycle cycles it), else MOMENTUM;
- the update -lr * t, and -BIAS_LR_FACTOR * lr * t for biases.
The schedules read the number of updates applied so far, as optax's
counters do: a skipped step advances neither.

Frozen subtrees (SOLVER.FIX_*) get ``requires_grad_(False)`` and are left
out of the optimizer: no gradient, no decay, no update.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .schedules import Schedule

FIX_FLAG_PREFIXES = {
    "FIX_BACKBONE": ("backbone",),
    "FIX_RPN": ("rpn_head",),
    "FIX_BOX_HEAD": ("box_extractor", "box_predictor"),
    "FIX_MASK_HEAD": ("mask_head",),
    "FIX_SHAPE_HEAD": ("shape_head",),
    "FIX_DISPARITY": ("idispnet",),
    "FIX_POINTRCNN_RPN": ("pointrcnn.rpn",),
    "FIX_POINTCLOUD": ("pointrcnn",),
}


def frozen_path_prefixes(**fix_flags: bool) -> Tuple[str, ...]:
    """Dotted module prefixes to freeze from the SOLVER.FIX_* flags given
    by name, e.g. ``frozen_path_prefixes(FIX_DISPARITY=True)`` (reference
    utils/fix_model.py:6-40)."""
    unknown = set(fix_flags) - set(FIX_FLAG_PREFIXES)
    if unknown:
        raise KeyError(f"unknown SOLVER flags {sorted(unknown)}")
    return tuple(p for flag, prefixes in FIX_FLAG_PREFIXES.items() if fix_flags.get(flag)
                 for p in prefixes)


class Optimizer:
    """SGD with the JAX package's parameter groups and schedules. ``step()``
    applies one update to the parameters' ``.grad`` and advances the
    schedules; ``count`` is the number of updates applied."""

    def __init__(self, groups: Dict[str, list], schedule: Schedule,
                 momentum_schedule: Optional[Schedule], momentum: float,
                 weight_decay: float, weight_decay_bias: float, bias_lr_factor: float):
        self.schedule, self.momentum_schedule = schedule, momentum_schedule
        self.momentum, self.bias_lr_factor = momentum, bias_lr_factor
        decay = {"base": weight_decay, "bias": weight_decay_bias}
        self.sgd = torch.optim.SGD(
            [{"params": ps, "weight_decay": decay[k], "kind": k} for k, ps in groups.items()
             if ps], lr=schedule(0), momentum=momentum)
        self.count = 0

    @property
    def params(self):
        return [p for g in self.sgd.param_groups for p in g["params"]]

    def step(self) -> None:
        lr = self.schedule(self.count)
        m = self.momentum if self.momentum_schedule is None \
            else self.momentum_schedule(self.count)
        for g in self.sgd.param_groups:
            g["lr"] = lr * (self.bias_lr_factor if g["kind"] == "bias" else 1.0)
            g["momentum"] = m
        self.sgd.step()
        self.count += 1


def make_optimizer(model: nn.Module, schedule: Schedule,
                   momentum_schedule: Optional[Schedule] = None,
                   frozen_prefixes: Tuple[str, ...] = (), momentum: float = 0.9, weight_decay: float = 0.0005,
                   weight_decay_bias: float = 0.0, bias_lr_factor: float = 2.0) -> Optimizer:
    """The SGD optimizer over `model`'s parameters (SOLVER.OPTIMIZER, which
    no config of the repo changes), from the SOLVER fields MOMENTUM,
    WEIGHT_DECAY, WEIGHT_DECAY_BIAS and BIAS_LR_FACTOR (the defaults are
    config/defaults.py's). Parameters under a frozen prefix get
    requires_grad_(False) here."""
    groups = {"base": [], "bias": []}
    for name, p in model.named_parameters():
        if any(name == pre or name.startswith(pre + ".") for pre in frozen_prefixes):
            p.requires_grad_(False)
        else:
            p.requires_grad_(True)
            groups["bias" if name.rsplit(".", 1)[-1] == "bias" else "base"].append(p)
    return Optimizer(groups, schedule, momentum_schedule, momentum, weight_decay,
                     weight_decay_bias, bias_lr_factor)
