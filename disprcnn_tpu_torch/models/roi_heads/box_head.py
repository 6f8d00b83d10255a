"""Stereo ROI box head (counterpart of
disprcnn_tpu/models/roi_heads/box_head.py).

- StereoBoxFeatureExtractor (reference roi_box_feature_extractors.py:85-123):
  pool both views at 7x7, channel concat, 7x7/7 conv to MLP_HEAD_DIM, ReLU,
  dropout 0.2, 1x1 conv, ReLU, dropout 0.2, spatial mean. Dropout acts in
  train mode only, on keep masks given as inputs: a kept entry is scaled by
  1 / 0.8, as Flax's Dropout does.
- StereoBoxPredictor (roi_box_predictors.py:61-85): linear class scores and
  per-class 6-parameter deltas.
- subsample and head_loss (loss.py:86-309): union-box IoU matching
  (0.5/0.5, no low-quality matches), balanced 512 at 0.25 sampling on given
  priorities, cross-entropy over the sampled rows and smooth-L1 (beta 1) on
  the matched class's 6 deltas of the positives, both divided by the
  sampled count.
- postprocess_batched (inference.py:86-275): per-class score threshold,
  decode, clip, LEFT-box NMS, then the top max_out detections per image.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.iou import pairwise_iou
from ...ops.losses import smooth_l1
from ...ops.nms import nms_topk_batched
from ...ops.topk_select import topk_scores
from ...parallel.mesh import sum_over_ranks
from ...structures.boxes import union_box
from ...structures.stereo import StereoBoxes
from ..rpn import box_coder
from ..rpn.matcher import balanced_sample, match
from .pooler import fpn_roi_align

_W10 = (10.0, 10.0, 5.0, 5.0)
DROPOUT = 0.2  # the extractor's dropout rate (roi_box_feature_extractors.py)


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float = DROPOUT) -> torch.Tensor:
    """Flax's Dropout on a given keep mask of x's shape: x / (1 - rate)
    where kept, else 0."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class StereoBoxFeatureExtractor(nn.Module):
    def __init__(self, in_channels: int, mlp_dim: int = 2048, resolution: int = 7,
                 scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
                 sampling_ratio: int = 0):
        super().__init__()
        self.resolution = resolution
        self.scales = tuple(scales)
        self.sampling_ratio = sampling_ratio
        self.rcnn_top0 = nn.Conv2d(2 * in_channels, mlp_dim, resolution, stride=resolution)
        self.rcnn_top1 = nn.Conv2d(mlp_dim, mlp_dim, 1)
        self.eval()  # train mode (dropout) only on request, as in the JAX package

    def forward(self, left_feats, right_feats, left_boxes: torch.Tensor,
                right_boxes: torch.Tensor, batch_idx: torch.Tensor,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """(N, 4) boxes per view -> (N, mlp_dim). In train mode `keep` holds
        the two dropout keep masks, (N, mlp_dim) bool each."""
        if self.training and keep is None:
            raise ValueError("the box head in train mode needs its dropout keep masks")
        pool = lambda feats, boxes: fpn_roi_align(
            feats, boxes, batch_idx, self.scales, self.resolution, self.sampling_ratio)
        x = torch.cat([pool(left_feats, left_boxes), pool(right_feats, right_boxes)], dim=1)
        for i, conv in enumerate((self.rcnn_top0, self.rcnn_top1)):
            x = F.relu(conv(x))
            if self.training:
                x = dropout(x, keep[i][..., None, None])
        return x.mean(dim=(2, 3))


class StereoBoxPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 2):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, num_classes * 6)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


def subsample(
    proposals: StereoBoxes,  # (B, P) with the GT appended
    gt_left: torch.Tensor,  # (B, M, 4)
    gt_right: torch.Tensor,  # (B, M, 4)
    gt_labels: torch.Tensor,  # (B, M) int
    gt_valid: torch.Tensor,  # (B, M) bool
    pos_priorities: torch.Tensor,  # (B, P) uniforms
    neg_priorities: torch.Tensor,  # (B, P) uniforms
    fg_iou: float = 0.5,
    bg_iou: float = 0.5,
    batch_size: int = 512,
    positive_fraction: float = 0.25,
):
    """Match the proposals to the GT and sample them -> (labels (B, P),
    reg_targets (B, P, 6), pos (B, P), sampled (B, P), matched_gt (B, P))."""
    quality = pairwise_iou(union_box(gt_left, gt_right), proposals.union()) \
        * proposals.valid[:, None, :]
    m = match(quality, gt_valid, fg_iou, bg_iou, allow_low_quality=False)
    mi = m.clamp_min(0)
    matched = torch.gather(gt_labels.long(), 1, mi)
    labels = torch.where(m >= 0, matched, torch.where(m == -1, torch.zeros_like(m),
                                                      torch.full_like(m, -1)))
    labels = torch.where(proposals.valid, labels, torch.full_like(labels, -1))
    gt6 = torch.gather(box_coder.join_stereo(gt_left, gt_right), 1,
                       mi[..., None].expand(-1, -1, 6))
    reg_targets = box_coder.encode6(
        gt6, box_coder.join_stereo(proposals.left, proposals.right), weights=_W10)
    pos, neg = balanced_sample(labels, batch_size, positive_fraction, pos_priorities,
                               neg_priorities)
    return labels, reg_targets, pos, pos | neg, mi


def head_loss(class_logits: torch.Tensor, box_deltas: torch.Tensor, labels: torch.Tensor,
              reg_targets: torch.Tensor, pos: torch.Tensor, sampled: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """class_logits (P, C), box_deltas (P, C*6), labels (P,), reg_targets
    (P, 6), pos and sampled (P,) bool -> (classifier loss, box loss)."""
    lbl = labels.clamp_min(0).long()
    logp = torch.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, 1, lbl[:, None])[:, 0]
    n = sum_over_ranks(sampled.sum()).clamp_min(1).to(ce.dtype)
    d = box_deltas.reshape(box_deltas.shape[0], -1, 6)
    d_pos = torch.gather(d, 1, lbl[:, None, None].expand(-1, 1, 6))[:, 0]
    box_loss = (smooth_l1(d_pos - reg_targets, beta=1.0) * pos[:, None]).sum() / n
    return (ce * sampled).sum() / n, box_loss


def postprocess_batched(
    class_logits: torch.Tensor,  # (B, P, C)
    box_deltas: torch.Tensor,  # (B, P, C*6)
    proposals: StereoBoxes,  # (B, P, ...)
    image_hw: Tuple[int, int],
    score_thresh: float = 0.05,
    nms_thresh: float = 0.5,
    detections_per_img: int = 100,
    max_out: int = 32,
) -> StereoBoxes:
    """-> StereoBoxes (B, max_out) with a 'labels' field."""
    bsz, p, num_classes = class_logits.shape
    dev = class_logits.device
    probs = torch.softmax(class_logits, dim=-1)
    d = box_deltas.reshape(bsz, p, num_classes, 6)
    left_d = d[..., [0, 1, 2, 3]].reshape(bsz * p, num_classes * 4)
    right_d = d[..., [4, 1, 5, 3]].reshape(bsz * p, num_classes * 4)
    left_all = box_coder.decode4(left_d, proposals.left.reshape(bsz * p, 4), _W10)
    right_all = box_coder.decode4(right_d, proposals.right.reshape(bsz * p, 4), _W10)
    left_all = left_all.reshape(bsz, p, num_classes * 4)
    right_all = right_all.reshape(bsz, p, num_classes * 4)
    h, w = image_hw
    lims = torch.tensor([w - 1.0, h - 1.0, w - 1.0, h - 1.0], device=dev)
    zero = torch.zeros(4, device=dev)
    k = min(detections_per_img, max_out)
    take = lambda x, i: torch.gather(x, 1, i[..., None].expand(-1, -1, x.shape[-1]))
    lefts, rights, scores, valids, labels = [], [], [], [], []
    for j in range(1, num_classes):
        lb = torch.clamp(left_all[:, :, j * 4:(j + 1) * 4], zero, lims)
        rb = torch.clamp(right_all[:, :, j * 4:(j + 1) * 4], zero, lims)
        sc = probs[:, :, j]
        ok = (sc > score_thresh) & proposals.valid
        idx, kept = nms_topk_batched(lb, sc, ok, nms_thresh, k)
        lefts.append(take(lb, idx))
        rights.append(take(rb, idx))
        scores.append(torch.gather(sc, 1, idx))
        valids.append(kept)
        labels.append(torch.full(idx.shape, j, dtype=torch.int64, device=dev))
    left, right = torch.cat(lefts, 1), torch.cat(rights, 1)
    score, valid, label = torch.cat(scores, 1), torch.cat(valids, 1), torch.cat(labels, 1)
    top, idx = topk_scores(torch.where(valid, score, torch.full_like(score, -1.0)), max_out)
    return StereoBoxes(
        left=take(left, idx), right=take(right, idx),
        score=torch.gather(score, 1, idx),
        valid=torch.gather(valid, 1, idx) & (top > 0),
        fields={"labels": torch.gather(label, 1, idx)},
    )
