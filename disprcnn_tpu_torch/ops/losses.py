"""Elementwise losses: smooth-L1, disparity EPE, the PSMNet deep-supervision
loss, binary cross-entropy and the binary focal loss (counterpart of
disprcnn_tpu/ops/losses.py; plain PyTorch, as the JAX package leaves them
to XLA)."""
from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.mesh import sum_over_ranks


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (reference layers/smooth_l1_loss.py)."""
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def masked_epe(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """|pred - target| averaged over the mask (reference
    utils/stereo_utils.py end_point_error)."""
    m = mask.to(pred.dtype)
    return ((pred - target).abs() * m).sum() / sum_over_ranks(m.sum()).clamp_min(1.0)


def psm_deep_supervision_loss(preds: Sequence[torch.Tensor], target: torch.Tensor,
                              mask: torch.Tensor,
                              weights: Sequence[float] = (0.5, 0.7, 1.0)) -> torch.Tensor:
    """Masked smooth-L1 of each PSMNet output against the target, weighted
    and summed (reference utils/loss_utils.py PSMLoss). With fewer outputs
    than weights the last weights apply: the last output always carries
    the last weight."""
    m = mask.to(target.dtype)
    denom = sum_over_ranks(m.sum()).clamp_min(1.0)
    total = target.new_zeros(())
    for w, p in zip(tuple(weights)[-len(preds):], preds):
        total = total + w * (smooth_l1(p - target) * m).sum() / denom
    return total


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise -(t log p + (1 - t) log(1 - p)) of p = sigmoid(logits),
    each log clipped at 1e-12 (rcnn3d.rcnn_loss's BinaryCrossEntropy)."""
    p = torch.sigmoid(logits)
    return -(targets * torch.log(p.clamp_min(1e-12))
             + (1 - targets) * torch.log((1 - p).clamp_min(1e-12)))


def sigmoid_focal_loss_binary(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                              alpha: float = 0.25) -> torch.Tensor:
    """Elementwise binary focal loss of {0, 1} float targets (reference
    lib/utils/loss_utils.py SigmoidFocalClassificationLoss)."""
    p = torch.sigmoid(logits)
    ce = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_t * (1 - p_t) ** gamma * ce
