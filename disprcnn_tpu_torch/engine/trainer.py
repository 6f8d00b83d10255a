"""One training step: forward with the model's losses, backward, gradient
clip, optimizer update (counterpart of disprcnn_tpu/engine/trainer.py;
reference engine/trainer.py:54-200).

The model runs in train mode and returns a dict whose ``loss*`` entries are
summed into the loss, or with learned uncertainty weights
(SOLVER.UNCERT_LOSS_WEIGHT, ``solver/build.py::UncertWeights``) weighted
as sum(u) + sum(l_i * exp(-u_i)) over the losses sorted by key. Their
gradient is not clipped with the parameters' (JAX clips its parameter
gradients alone), and they take their own optimizer's update in the same
step. A step whose loss or any gradient (u's too) is not finite applies
nothing: the parameters, u, both optimizers' state and schedules and the
BatchNorm running statistics keep their values, only the step count
advances, and the metrics report ``skipped_nonfinite`` (the reference's
ALLOW_EXCEPTION skips such an iteration, engine/trainer.py:116-123).

A trainable parameter that the backward pass leaves without a gradient is
counted in the metrics (``params_without_grad``) and updated with a zero
gradient, as optax updates a parameter whose gradient is zero (its weight
decay and momentum still apply). A count above zero on the card means that
a kernel's output was cut off from autograd.

With several ranks (parallel/) each rank runs the step on its share of
the global batch, and its losses are its shares of the global batch's
(every normalizer is a count over the ranks, train-mode BN takes the
global statistics). After the backward pass the gradients are summed over
the ranks in one flat buffer, before the finite check and the clip, so
every rank takes the same decision and the same update: the step of one
process at the global batch, as the JAX package's step over its mesh is.
u's gradient is summed with them; each rank's loss holds sum(u) / ranks,
so that the sum over the ranks is the global loss and its gradient. The
losses in the metrics are summed over the ranks too.

A bf16 model (TPU.COMPUTE_DTYPE bfloat16, ROADMAP A8.4) keeps float32
parameters: its gradients come out float32 (each cast to bf16 in the
forward widens its gradient back), and the finite check, the clip, the
optimizer and the BatchNorm running statistics stay float32, as JAX's
step keeps its float32 parameters and batch statistics.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..parallel.mesh import all_reduce_grads, sum_over_ranks
from ..parallel.multihost import process_count
from ..solver.build import Optimizer, UncertWeights


def total_loss(losses: Dict[str, torch.Tensor], uncert: Optional[torch.Tensor],
               u_share: float = 1.0) -> torch.Tensor:
    """The sum of the losses (in key order), or the uncertainty weighting
    u_share * sum(u) + sum(l_i * exp(-u_i)) (reference trainer.py:44-51;
    u_share is a rank's share of the global batch)."""
    # a bf16 model's losses join in float32, as JAX's sum promotes them
    vals = [v.to(torch.promote_types(v.dtype, torch.float32)) for _, v in sorted(losses.items())]
    if uncert is None:
        return torch.stack(vals).sum()
    u_sum = uncert.sum() if u_share == 1.0 else uncert.sum() * u_share
    return u_sum + (torch.stack(vals) * torch.exp(-uncert[:len(vals)])).sum()


class TrainStep:
    """``step(batch)`` runs one step of `model` on the keyword arguments in
    `batch` (plus `forward_kwargs`) and returns its metrics; ``step.count``
    is the number of steps taken, skipped ones included. ``uncert`` holds
    the learned loss weights, or None."""

    def __init__(self, model: nn.Module, optimizer: Optimizer, do_grad_clip: bool,
                 grad_clip: float, forward_kwargs: dict,
                 uncert: Optional[UncertWeights] = None):
        self.model, self.optimizer, self.uncert = model, optimizer, uncert
        self.do_grad_clip, self.grad_clip = do_grad_clip, grad_clip
        self.forward_kwargs = forward_kwargs
        self.count = 0

    def __call__(self, batch: dict) -> Dict[str, torch.Tensor]:
        model, params = self.model, self.optimizer.params
        model.train()
        saved = [b.detach().clone() for b in model.buffers()]
        u = None if self.uncert is None else self.uncert.u
        for p in params + ([] if u is None else [u]):
            p.grad = None
        out = model(**batch, **self.forward_kwargs)
        losses = {k: v for k, v in out.items() if k.startswith("loss")}
        loss = total_loss(losses, u, 1.0 / process_count())
        loss.backward()
        missing = sum(p.grad is None for p in params)
        for p in params + ([] if u is None else [u]):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if process_count() > 1:
            all_reduce_grads(grads + ([] if u is None else [u.grad]))
            names = sorted(losses)
            summed = sum_over_ranks(torch.stack([loss.detach()] + [losses[k].detach()
                                                                   for k in names]))
            loss, losses = summed[0], dict(zip(names, summed[1:]))
        finite = bool(torch.isfinite(loss)
                      & torch.stack([torch.isfinite(g).all()
                                     for g in grads + ([] if u is None else [u.grad])]).all())
        if finite:
            if self.do_grad_clip:
                gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
                scale = torch.clamp(self.grad_clip / gnorm.clamp_min(1e-6), max=1.0)
                for g in grads:
                    g.mul_(scale)
            self.optimizer.step()
            if u is not None:
                self.uncert.step()
        else:
            with torch.no_grad():
                for b, old in zip(model.buffers(), saved):
                    b.copy_(old)
        self.count += 1
        return {"loss_total": loss.detach(), **{k: v.detach() for k, v in losses.items()},
                "skipped_nonfinite": torch.tensor(float(not finite)),
                "params_without_grad": torch.tensor(missing)}


def make_train_step(model: nn.Module, optimizer: Optimizer, do_grad_clip: bool = False,
                    grad_clip: float = 1.0, forward_kwargs: Optional[dict] = None,
                    uncert: Optional[UncertWeights] = None) -> Callable:
    """A TrainStep. `forward_kwargs` are the fixed model arguments (the JAX
    package's apply_kwargs, e.g. train_psm/train_pc); `uncert` the learned
    loss weights (the JAX package's uncert_count and uncert_tx)."""
    return TrainStep(model, optimizer, do_grad_clip, grad_clip, dict(forward_kwargs or {}),
                     uncert)
