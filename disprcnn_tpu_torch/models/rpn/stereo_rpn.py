"""Stereo RPN head, proposal selection and loss (counterpart of
disprcnn_tpu/models/rpn/stereo_rpn.py; reference
modeling/rpn/stereo_rpn/srpn.py, inference.py, loss.py).

- SRPNHead: one shared 3x3 conv over both views, channel concat, then 1x1
  heads for A*2 objectness logits and A*6 stereo deltas, per FPN level.
- postprocess_batched: softmax objectness, exact top pre_nms_top_n, decode,
  split L/R, clip, min-size filter, double-view NMS to post_nms_top_n. The
  proposals' coordinates keep their gradient (only the NMS decision is
  cut), as in the JAX package.
- loss: anchors matched to the union of each GT pair (0.7/0.3, low-quality
  recovery), anchors that are not visible ignored, balanced 256 at 0.5
  sampling on given priorities, 2-way cross-entropy over the sampled
  anchors and smooth-L1 (beta 1/9) on the 6 deltas of the positives, both
  divided by the batch's sampled count.

The JAX package's level-atlas variant of the head (DISPRCNN_SRPN_ATLAS,
off by default) is a TPU layout form with the same outputs; it is not
carried over.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.iou import pairwise_iou
from ...ops.losses import smooth_l1
from ...ops.nms import double_view_nms_topk_batched
from ...ops.topk_select import topk_scores
from ...parallel.mesh import sum_over_ranks
from ...structures.boxes import union_box
from ...structures.stereo import StereoBoxes
from . import box_coder
from .matcher import balanced_sample, match


class SRPNHead(nn.Module):
    """Shared-conv stereo RPN head (reference srpn.py:14-51).

    quirk_exact reproduces the reference's in-head softmax over the PLANAR
    (2, A) channel view (channel c paired with c + A), whose output is then
    read INTERLEAVED as (A, 2); the postprocessor must then rank by the raw
    values (scores_are_probs). The default is the clean form: raw
    interleaved logits, one softmax at the consumer."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3, quirk_exact: bool = False):
        super().__init__()
        self.num_anchors = num_anchors
        self.quirk_exact = quirk_exact
        self.conv = nn.Conv2d(in_channels, in_channels * 2, 3, padding=1)
        self.cls_logits = nn.Conv2d(in_channels * 4, num_anchors * 2, 1)
        self.bbox_pred = nn.Conv2d(in_channels * 4, num_anchors * 6, 1)

    def _read_cls(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 2A) -> (B, H, W, A, 2)."""
        b, h, w, _ = raw.shape
        a = self.num_anchors
        if self.quirk_exact:
            raw = torch.softmax(raw.reshape(b, h, w, 2, a), dim=-2).reshape(b, h, w, 2 * a)
        return raw.reshape(b, h, w, a, 2)

    def forward(self, both_feats: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """both_feats: per level the (2B, C, H, W) maps of left then right.
        -> per level (obj_logits (B, H, W, A, 2), deltas (B, H, W, A, 6))."""
        outs = []
        for f2 in both_feats:
            t2 = F.relu(self.conv(f2))
            b = t2.shape[0] // 2
            t = torch.cat([t2[:b], t2[b:]], dim=1)
            cls = self.cls_logits(t).permute(0, 2, 3, 1)
            box = self.bbox_pred(t).permute(0, 2, 3, 1)
            _, h, w, _ = box.shape
            outs.append((self._read_cls(cls), box.reshape(b, h, w, self.num_anchors, 6)))
        return outs


def flatten_levels(head_outs) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (B, N_tot, 2) logits, (B, N_tot, 6) deltas in (level, H, W, A)
    anchor order."""
    logits = torch.cat([o[0].reshape(o[0].shape[0], -1, 2) for o in head_outs], dim=1)
    deltas = torch.cat([o[1].reshape(o[1].shape[0], -1, 6) for o in head_outs], dim=1)
    return logits, deltas


def postprocess_batched(
    anchors: torch.Tensor,  # (N_tot, 4)
    obj_logits: torch.Tensor,  # (B, N_tot, 2)
    deltas: torch.Tensor,  # (B, N_tot, 6)
    image_hw: Tuple[int, int],
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    min_size: float,
    scores_are_probs: bool = False,
) -> StereoBoxes:
    """-> StereoBoxes with (B, post_nms_top_n) rows."""
    bsz = obj_logits.shape[0]
    scores = obj_logits[..., 1] if scores_are_probs else torch.softmax(obj_logits, dim=-1)[..., 1]
    k = min(pre_nms_top_n, anchors.shape[0])
    top_scores, top_idx = topk_scores(scores, k)  # (B, k)
    d = torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 6))
    a = anchors[top_idx]  # (B, k, 4)
    box6 = box_coder.decode6(d.reshape(-1, 6), a.reshape(-1, 4))
    left, right = box_coder.split_stereo(box6)
    h, w = image_hw
    lims = torch.tensor([w - 1.0, h - 1.0, w - 1.0, h - 1.0], device=left.device)
    zero = torch.zeros(4, device=left.device)
    left = torch.clamp(left.reshape(bsz, k, 4), zero, lims)
    right = torch.clamp(right.reshape(bsz, k, 4), zero, lims)

    def big(bx):
        return (bx[..., 2] - bx[..., 0] >= min_size) & (bx[..., 3] - bx[..., 1] >= min_size)

    valid = big(left) & big(right)
    # the top-k rows are already score-descending: no second sort
    idx, ok = double_view_nms_topk_batched(
        left, right, top_scores, valid, nms_thresh, post_nms_top_n, presorted=True,
    )
    take = lambda x: torch.gather(x, 1, idx[..., None].expand(-1, -1, 4))
    return StereoBoxes(left=take(left), right=take(right),
                       score=torch.gather(top_scores, 1, idx), valid=ok)


def loss(
    anchors: torch.Tensor,  # (N, 4)
    visibility: torch.Tensor,  # (N,) bool
    obj_logits: torch.Tensor,  # (B, N, 2)
    deltas: torch.Tensor,  # (B, N, 6)
    gt_left: torch.Tensor,  # (B, M, 4)
    gt_right: torch.Tensor,  # (B, M, 4)
    gt_valid: torch.Tensor,  # (B, M) bool
    pos_priorities: torch.Tensor,  # (B, N) uniforms
    neg_priorities: torch.Tensor,  # (B, N) uniforms
    fg_iou: float = 0.7,
    bg_iou: float = 0.3,
    batch_per_image: int = 256,
    positive_fraction: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (objectness loss, box loss) of the batch."""
    quality = pairwise_iou(union_box(gt_left, gt_right), anchors)  # (B, M, N)
    m = match(quality, gt_valid, fg_iou, bg_iou, allow_low_quality=True)
    one, zero = torch.ones_like(quality[:, 0]), torch.zeros_like(quality[:, 0])
    labels = torch.where(m >= 0, one, torch.where(m == -1, zero, -one))
    labels = torch.where(visibility, labels, -one)
    pos, neg = balanced_sample(labels, batch_per_image, positive_fraction, pos_priorities,
                               neg_priorities)
    sampled = pos | neg
    gt6 = box_coder.join_stereo(gt_left, gt_right)
    gt6 = torch.gather(gt6, 1, m.clamp_min(0)[..., None].expand(-1, -1, 6))
    reg_targets = box_coder.encode6(gt6, anchors.expand(gt6.shape[0], -1, -1))
    box_l = (smooth_l1(deltas - reg_targets, beta=1.0 / 9) * pos[..., None]).sum()
    logp = torch.log_softmax(obj_logits, dim=-1)
    ce = -torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    total = sum_over_ranks(sampled.sum()).clamp_min(1).to(ce.dtype)
    return (ce * sampled).sum() / total, box_l / total
