"""The optimizers of the JAX package's solver (counterpart of
disprcnn_tpu/solver/build.py; reference solver/build.py:10-57) over two
parameter groups, with the rate (and SGD's momentum, Adam's b1) set from
the schedules before every update. SOLVER.OPTIMIZER picks one:

- "SGD", a ``torch.optim.SGD``. The optax chain it matches, per parameter:
  weight decay added to the gradient before the momentum
  (``add_decayed_weights``): WEIGHT_DECAY for weights, WEIGHT_DECAY_BIAS
  for biases (every parameter named ``bias``, the BatchNorm shifts too);
  the momentum trace t = g + m * t (``optax.trace``), m from the momentum
  schedule when there is one (OneCycle cycles it), else MOMENTUM; the
  update -lr * t, and -BIAS_LR_FACTOR * lr * t for biases.
- "Adam", written out as optax's ``scale_by_adam`` computes it, in
  float32 and in its order: the same weight decay added to the gradient;
  mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu; the bias
  corrections 1 - b1^n and 1 - b2^n at the current b1 and the update count
  n (counting this one); the update mu_hat / (sqrt(nu_hat) + eps), eps
  1e-8 outside the root, times -lr, and times BIAS_LR_FACTOR for biases.
  b1 comes from the momentum schedule when there is one, else 0.9 (optax's
  default, not MOMENTUM, as the JAX package builds it); b2 0.999. The
  complements 1 - b are rounded as optax rounds them: from the double
  constants without a schedule, in float32 with one (optax then injects
  the hyperparameters as float32 arrays).
Any other name raises NotImplementedError, as the JAX package's does.

The schedules read the number of updates applied so far, as optax's
counters do: a skipped step advances neither. ``state_dict()`` holds the
optimizer's state with that count, for utils/checkpoint.py.

Frozen subtrees (SOLVER.FIX_*) get ``requires_grad_(False)`` and are left
out of the optimizer: no gradient, no decay, no update.

``UncertWeights`` are SOLVER.UNCERT_LOSS_WEIGHT's learned loss weights
with their own optimizer (JAX tools/train_net.py:113-121).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

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

    def state_dict(self) -> dict:
        return {"count": self.count, "sgd": self.sgd.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state["sgd"])
        self.count = int(state["count"])


class UncertWeights:
    """The learned uncertainty loss weights u (count,), from -1.0, and their
    optimizer, the JAX package's uncert_tx: the momentum trace t = g + m t
    (optax.trace, m = SOLVER.MOMENTUM, no schedule) and the update -lr * t
    at the LR schedule's value for this optimizer's own update count; no
    weight decay and no bias factor. ``step()`` applies one update to
    ``u.grad``; ``state_dict()`` holds u, the trace and the count."""

    def __init__(self, count: int, schedule: Schedule, momentum: float, device=None):
        self.u = torch.full((count,), -1.0, device=device, requires_grad=True)
        self.schedule = schedule
        self.sgd = torch.optim.SGD([self.u], lr=schedule(0), momentum=momentum)
        self.count = 0

    def step(self) -> None:
        self.sgd.param_groups[0]["lr"] = self.schedule(self.count)
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"u": self.u.detach().clone(), "count": self.count, "sgd": self.sgd.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            self.u.copy_(state["u"])
        self.sgd.load_state_dict(state["sgd"])
        self.count = int(state["count"])


class Adam:
    """Adam with the JAX package's parameter groups and schedules (see the
    module doc); the same interface as Optimizer. ``mu`` and ``nu`` hold
    the moments of each group's parameters."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, groups: Dict[str, list], schedule: Schedule,
                 momentum_schedule: Optional[Schedule], weight_decay: float,
                 weight_decay_bias: float, bias_lr_factor: float):
        self.schedule, self.momentum_schedule = schedule, momentum_schedule
        self.groups = {k: ps for k, ps in groups.items() if ps}
        self.decay = {"base": weight_decay, "bias": weight_decay_bias}
        self.factor = {"base": 1.0, "bias": bias_lr_factor}
        self.mu = {k: [torch.zeros_like(p) for p in ps] for k, ps in self.groups.items()}
        self.nu = {k: [torch.zeros_like(p) for p in ps] for k, ps in self.groups.items()}
        self.count = 0

    @property
    def params(self):
        return [p for ps in self.groups.values() for p in ps]

    @torch.no_grad()
    def step(self) -> None:
        f32 = np.float32
        n = self.count + 1
        b2 = f32(self.B2)
        if self.momentum_schedule is None:  # constants: the complements in double
            b1, one_b1, one_b2 = f32(self.B1), f32(1.0 - self.B1), f32(1.0 - self.B2)
        else:  # injected hyperparameters are float32 arrays: the complements in float32
            b1 = f32(self.momentum_schedule(self.count))
            one_b1, one_b2 = f32(1.0) - b1, f32(1.0) - b2
        bc1 = float(f32(1.0) - b1 ** np.int32(n))
        bc2 = float(f32(1.0) - b2 ** np.int32(n))
        neg_lr = float(-f32(self.schedule(self.count)))
        for k, ps in self.groups.items():
            grads = [p.grad for p in ps]
            if self.decay[k]:
                grads = torch._foreach_add(grads, ps, alpha=self.decay[k])
            mu, nu = self.mu[k], self.nu[k]
            torch._foreach_mul_(mu, float(b1))
            torch._foreach_add_(mu, torch._foreach_mul(grads, float(one_b1)))
            torch._foreach_mul_(nu, float(b2))
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                       float(one_b2)))
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, float(f32(self.EPS)))
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
            torch._foreach_mul_(upd, neg_lr)
            if self.factor[k] != 1.0:
                torch._foreach_mul_(upd, self.factor[k])
            torch._foreach_add_(ps, upd)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": {k: list(v) for k, v in self.mu.items()},
                "nu": {k: list(v) for k, v in self.nu.items()}}

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            for key in ("mu", "nu"):
                mine = getattr(self, key)
                if set(state[key]) != set(mine):
                    raise KeyError(f"Adam state groups {sorted(state[key])}, expected "
                                   f"{sorted(mine)}")
                for k, ts in mine.items():
                    if len(state[key][k]) != len(ts):
                        raise ValueError(f"Adam state: {len(state[key][k])} {key} tensors in "
                                         f"group {k}, expected {len(ts)}")
                    for t, v in zip(ts, state[key][k]):
                        t.copy_(v)
        self.count = int(state["count"])


def make_optimizer(model: nn.Module, schedule: Schedule,
                   momentum_schedule: Optional[Schedule] = None,
                   frozen_prefixes: Tuple[str, ...] = (), momentum: float = 0.9,
                   weight_decay: float = 0.0005, weight_decay_bias: float = 0.0,
                   bias_lr_factor: float = 2.0, optimizer: str = "SGD"):
    """The optimizer SOLVER.OPTIMIZER names ("SGD" or "Adam") over `model`'s
    parameters, from the SOLVER fields MOMENTUM (SGD only), WEIGHT_DECAY,
    WEIGHT_DECAY_BIAS and BIAS_LR_FACTOR (the defaults are
    config/defaults.py's). Parameters under a frozen prefix get
    requires_grad_(False) here."""
    if optimizer not in ("SGD", "Adam"):
        raise NotImplementedError(optimizer)
    groups = {"base": [], "bias": []}
    for name, p in model.named_parameters():
        if any(name == pre or name.startswith(pre + ".") for pre in frozen_prefixes):
            p.requires_grad_(False)
        else:
            p.requires_grad_(True)
            groups["bias" if name.rsplit(".", 1)[-1] == "bias" else "base"].append(p)
    if optimizer == "Adam":
        return Adam(groups, schedule, momentum_schedule, weight_decay, weight_decay_bias,
                    bias_lr_factor)
    return Optimizer(groups, schedule, momentum_schedule, momentum, weight_decay,
                     weight_decay_bias, bias_lr_factor)
