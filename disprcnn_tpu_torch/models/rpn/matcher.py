"""IoU matcher and balanced positive/negative sampler, fixed-shape
(counterpart of disprcnn_tpu/models/rpn/matcher.py; reference
modeling/matcher.py:5-110, modeling/balanced_positive_negative_sampler.py).

Leading axes are free: (M, N) quality and (N,) labels for one image, or
(B, M, N) and (B, N) for a batch.
- match codes: >= 0 the matched GT index; -1 below the low threshold; -2
  between the two.
- low-quality recovery: a prediction that realizes some valid GT's best
  IoU keeps its own argmax match.
- sampling: up to batch * fraction positives and batch - (positives)
  negatives, each set the first `count` of its candidates in descending
  order of the given uniform priorities (ties to the lower index), as the
  JAX package's top-k over keyed uniforms selects them. The priorities are
  inputs: every train-time random draw is.
"""
from __future__ import annotations

import torch

BELOW_LOW = -1
BETWEEN = -2


def match(quality: torch.Tensor, gt_valid: torch.Tensor, high: float, low: float,
          allow_low_quality: bool = True) -> torch.Tensor:
    """quality (..., M, N), gt_valid (..., M) bool -> (..., N) int64 codes."""
    q = torch.where(gt_valid[..., :, None], quality, torch.full_like(quality, -1.0))
    matched_vals, argmax_gt = q.max(dim=-2)  # the first maximal GT
    matches = torch.where(matched_vals >= high, argmax_gt,
                          torch.where(matched_vals < low, torch.full_like(argmax_gt, BELOW_LOW),
                                      torch.full_like(argmax_gt, BETWEEN)))
    if allow_low_quality:
        gt_best = q.max(dim=-1, keepdim=True).values  # (..., M, 1)
        is_best = ((q == gt_best) & gt_valid[..., :, None] & (gt_best > 0)).any(dim=-2)
        matches = torch.where(is_best, argmax_gt, matches)
    return matches


def _pick(priorities: torch.Tensor, mask: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The first `count` (per row) of the stable descending order of
    where(mask, priorities, -1), restricted to the mask."""
    pri = torch.where(mask, priorities, torch.full_like(priorities, -1.0))
    order = torch.sort(pri, dim=-1, descending=True, stable=True).indices
    rank = torch.arange(pri.shape[-1], device=pri.device)
    sel = torch.zeros_like(mask).scatter(-1, order, rank < count[..., None])
    return sel & mask


def balanced_sample(labels: torch.Tensor, batch_size: int, positive_fraction: float,
                    pos_priorities: torch.Tensor, neg_priorities: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """labels (..., N): >= 1 positive, 0 negative, else ignored; priorities
    (..., N) uniforms in [0, 1). -> (pos, neg) bool masks (..., N)."""
    is_pos, is_neg = labels >= 1, labels == 0
    max_pos = int(batch_size * positive_fraction)
    num_pos = is_pos.sum(-1).clamp_max(max_pos)
    num_neg = torch.minimum(is_neg.sum(-1), batch_size - num_pos)
    return _pick(pos_priorities, is_pos, num_pos), _pick(neg_priorities, is_neg, num_neg)
