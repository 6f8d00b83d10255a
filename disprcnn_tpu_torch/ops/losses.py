"""Elementwise losses: smooth-L1, disparity EPE, the PSMNet deep-supervision
loss, binary cross-entropy, the binary and the multi-class sigmoid focal
loss and the Dice loss (counterpart of disprcnn_tpu/ops/losses.py; plain
PyTorch, as the JAX package leaves them to XLA)."""
from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.mesh import sum_over_ranks


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (reference layers/smooth_l1_loss.py)."""
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0,
                   weight=None) -> torch.Tensor:
    """Elementwise smooth_l1(pred - target), times `weight` where given."""
    out = smooth_l1(pred - target, beta)
    return out if weight is None else out * weight


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


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """(N, C) logits of classes 1..C (no background column), (N,) int
    targets in [0..C] (0 background, -1 ignored) -> the (N, C) loss map
    (reference csrc/cuda/SigmoidFocalLoss_cuda.cu): column c is positive
    iff target == c, each log clipped at 1e-12; ignored rows give 0."""
    class_ids = torch.arange(1, logits.shape[-1] + 1, device=logits.device)
    t = (targets[:, None] == class_ids[None, :]).to(logits.dtype)
    p = torch.sigmoid(logits)
    term_pos = -t * alpha * (1.0 - p) ** gamma * torch.log(p.clamp_min(1e-12))
    term_neg = -(1.0 - t) * (1.0 - alpha) * p ** gamma * torch.log((1.0 - p).clamp_min(1e-12))
    keep = (targets >= 0)[:, None]
    return torch.where(keep, term_pos + term_neg, torch.zeros_like(logits))


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """1 - (2 sum(p t) + eps) / (sum(p) + sum(t) + eps) over every element,
    p = sigmoid(logits) (reference loss_utils.DiceLoss). The 3D RPN's Dice
    form (rpn3d.rpn_loss) is another: no factor 2, over cared points."""
    p = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1).to(p.dtype)
    return 1.0 - (2.0 * (p * t).sum() + eps) / (p.sum() + t.sum() + eps)
