"""Single-view RPN of the mono detector (counterpart of
disprcnn_tpu/models/rpn/rpn.py; reference modeling/rpn/rpn.py:15-209).

- RPNHead: a shared 3x3 conv + ReLU, then 1x1 heads for A objectness
  logits and A*4 deltas, per level. Flax reshapes its NHWC channels
  anchor-major, so the NCHW outputs are permuted to (B, H, W, ch) before
  the reshape: the anchors are ordered (level, H, W, A).
- postprocess_batched: sigmoid, exact top pre_nms_top_n (ties to the lower
  index), decode, clip, min-size filter, then greedy NMS (row 1,
  ops/nms.py) to post_nms_top_n. The proposals' coordinates keep their
  gradient; only the NMS decision is cut.
- loss: anchors matched to the GT (0.7/0.3, low-quality recovery), anchors
  that are not visible ignored, balanced sampling on given priorities,
  smooth-L1 (beta 1/9) on the positives' 4 deltas and BCE over the sampled
  anchors, both divided by the batch's sampled count.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.iou import pairwise_iou
from ...ops.losses import binary_cross_entropy, smooth_l1
from ...ops.nms import nms_topk_batched
from ...ops.topk_select import topk_scores
from ...parallel.mesh import sum_over_ranks
from ...structures.boxes import Boxes2D
from . import box_coder
from .matcher import balanced_sample, match


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per level (B, C, H, W) -> (logits (B, H, W, A), deltas (B, H, W, A, 4))."""
        outs = []
        for f in feats:
            t = F.relu(self.conv(f))
            cls = self.cls_logits(t).permute(0, 2, 3, 1)
            box = self.bbox_pred(t).permute(0, 2, 3, 1)
            b, h, w, _ = box.shape
            outs.append((cls, box.reshape(b, h, w, self.num_anchors, 4)))
        return outs


def flatten_levels(head_outs) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (B, N_tot) logits, (B, N_tot, 4) deltas in (level, H, W, A) order."""
    logits = torch.cat([o[0].reshape(o[0].shape[0], -1) for o in head_outs], dim=1)
    deltas = torch.cat([o[1].reshape(o[1].shape[0], -1, 4) for o in head_outs], dim=1)
    return logits, deltas


def postprocess_batched(
    anchors: torch.Tensor,  # (N, 4)
    obj_logits: torch.Tensor,  # (B, N)
    deltas: torch.Tensor,  # (B, N, 4)
    image_hw: Tuple[int, int],
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    min_size: float,
) -> Boxes2D:
    """-> Boxes2D (B, min(post_nms_top_n, k)) with an "objectness" field."""
    b = obj_logits.shape[0]
    k = min(pre_nms_top_n, anchors.shape[0])
    top_s, top_i = topk_scores(torch.sigmoid(obj_logits), k)
    d = torch.gather(deltas, 1, top_i[..., None].expand(-1, -1, 4))
    boxes = box_coder.decode4(d.reshape(-1, 4), anchors[top_i].reshape(-1, 4)).reshape(b, k, 4)
    h, w = image_hw
    lims = torch.tensor([w - 1.0, h - 1.0, w - 1.0, h - 1.0], device=boxes.device)
    boxes = torch.clamp(boxes, torch.zeros(4, device=boxes.device), lims)
    big = ((boxes[..., 2] - boxes[..., 0] >= min_size)
           & (boxes[..., 3] - boxes[..., 1] >= min_size))
    # the top-k rows are already score-descending: no second sort
    idx, ok = nms_topk_batched(boxes, top_s, big, nms_thresh, min(post_nms_top_n, k),
                               presorted=True)
    return Boxes2D(xyxy=torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), valid=ok,
                   size=(w, h), fields={"objectness": torch.gather(top_s, 1, idx)})


def loss(
    anchors: torch.Tensor,  # (N, 4)
    visibility: torch.Tensor,  # (N,) bool
    obj_logits: torch.Tensor,  # (B, N)
    deltas: torch.Tensor,  # (B, N, 4)
    gt: torch.Tensor,  # (B, M, 4)
    gt_valid: torch.Tensor,  # (B, M) bool
    pos_priorities: torch.Tensor,  # (B, N) uniforms
    neg_priorities: torch.Tensor,  # (B, N) uniforms
    fg_iou: float = 0.7,
    bg_iou: float = 0.3,
    batch_per_image: int = 256,
    positive_fraction: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (objectness loss, box loss) of the batch."""
    m = match(pairwise_iou(gt, anchors), gt_valid, fg_iou, bg_iou, allow_low_quality=True)
    one, zero = torch.ones_like(obj_logits), torch.zeros_like(obj_logits)
    labels = torch.where(m >= 0, one, torch.where(m == -1, zero, -one))
    labels = torch.where(visibility, labels, -one)
    pos, neg = balanced_sample(labels, batch_per_image, positive_fraction, pos_priorities,
                               neg_priorities)
    sampled = pos | neg
    matched = torch.gather(gt, 1, m.clamp_min(0)[..., None].expand(-1, -1, 4))
    reg_targets = box_coder.encode4(matched, anchors.expand(gt.shape[0], -1, -1))
    box_l = (smooth_l1(deltas - reg_targets, beta=1.0 / 9) * pos[..., None]).sum()
    bce = binary_cross_entropy(obj_logits, labels.clamp_min(0))
    total = sum_over_ranks(sampled.sum()).clamp_min(1).to(bce.dtype)
    return (bce * sampled).sum() / total, box_l / total
