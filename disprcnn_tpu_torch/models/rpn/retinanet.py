"""RetinaNet's head, anchors, focal loss and postprocessing (counterpart of
disprcnn_tpu/models/rpn/retinanet.py; reference
modeling/rpn/retinanet/{retinanet.py, inference.py, loss.py}).

- RetinaNetHead: two towers of num_convs 3x3 convs + ReLU shared across
  the levels (``cls_tower{i}``, ``bbox_tower{i}``), then 3x3 convs to A*C
  class logits (``cls_logits``, its bias at the prior -log((1 - p) / p))
  and A*4 deltas (``bbox_pred``). Flax reshapes NHWC channels anchor-major:
  the NCHW outputs are permuted to (B, H, W, ch) before the reshape.
- octave_anchor_generator: scales_per_octave sizes a level, size *
  octave^(i / scales_per_octave).
- retinanet_loss: anchors matched at 0.5/0.4 with low-quality recovery,
  the sigmoid focal loss over every class column divided by the image's
  positives (at least 1), smooth-L1 (beta 0.11) on the positives' deltas
  likewise, each averaged over the images, the box loss times
  reg_weight / 4.
- retinanet_postprocess_batched: the best class's sigmoid and its label
  (+ 1), the top pre_nms_top_n by a stable sort (ties to the lower index,
  as XLA's top_k), decode, clip, score > score_thresh, then greedy NMS
  (row 1, ops/nms.py) to max_det.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.iou import pairwise_iou
from ...ops.losses import sigmoid_focal_loss, smooth_l1
from ...ops.nms import nms_topk_batched
from ...ops.topk_select import topk_scores
from ...structures.boxes import Boxes2D
from . import box_coder
from .anchors import AnchorGenerator, cell_anchors
from .matcher import match


def prior_bias(prior_prob: float) -> float:
    """The class logits' bias that gives every class the sigmoid prior_prob."""
    return -math.log((1 - prior_prob) / prior_prob)


class RetinaNetHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 80, num_anchors: int = 9,
                 num_convs: int = 4, channels: int = 256, prior_prob: float = 0.01):
        super().__init__()
        self.num_classes, self.num_anchors, self.num_convs = num_classes, num_anchors, num_convs
        # init_random_ draws cls_logits' bias at this constant, as Flax's bias_init
        self.cls_logits_prior_bias = prior_bias(prior_prob)
        for i in range(num_convs):
            cin = in_channels if i == 0 else channels
            self.add_module(f"cls_tower{i}", nn.Conv2d(cin, channels, 3, padding=1))
            self.add_module(f"bbox_tower{i}", nn.Conv2d(cin, channels, 3, padding=1))
        self.cls_logits = nn.Conv2d(channels, num_anchors * num_classes, 3, padding=1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 3, padding=1)
        with torch.no_grad():
            self.cls_logits.bias.fill_(self.cls_logits_prior_bias)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per level (B, C_in, H, W) -> (class logits (B, H*W*A, C), deltas
        (B, H*W*A, 4))."""
        outs = []
        for f in feats:
            c, bx = f, f
            for i in range(self.num_convs):
                c = F.relu(getattr(self, f"cls_tower{i}")(c))
                bx = F.relu(getattr(self, f"bbox_tower{i}")(bx))
            b = f.shape[0]
            outs.append((self.cls_logits(c).permute(0, 2, 3, 1).reshape(b, -1, self.num_classes),
                         self.bbox_pred(bx).permute(0, 2, 3, 1).reshape(b, -1, 4)))
        return outs


def octave_anchor_generator(sizes=(32, 64, 128, 256, 512), strides=(8, 16, 32, 64, 128),
                            ratios=(0.5, 1.0, 2.0), octave: float = 2.0,
                            scales_per_octave: int = 3) -> AnchorGenerator:
    """Anchors of scales_per_octave sub-scales a level (reference
    make_anchor_generator_retinanet)."""
    cells = [cell_anchors(st, [sz * octave ** (i / scales_per_octave)
                               for i in range(scales_per_octave)], ratios)
             for st, sz in zip(strides, sizes)]
    return AnchorGenerator.from_cells(cells, strides)


def retinanet_loss(
    anchors: torch.Tensor,  # (N, 4)
    cls_logits: torch.Tensor,  # (B, N, C)
    box_deltas: torch.Tensor,  # (B, N, 4)
    gt: torch.Tensor,  # (B, M, 4)
    gt_labels: torch.Tensor,  # (B, M) int, classes 1..C
    gt_valid: torch.Tensor,  # (B, M) bool
    fg_iou: float = 0.5,
    bg_iou: float = 0.4,
    gamma: float = 2.0,
    alpha: float = 0.25,
    reg_weight: float = 4.0,
    reg_beta: float = 0.11,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (classification loss, box loss) of the batch."""
    b, n, c = cls_logits.shape
    m = match(pairwise_iou(gt, anchors), gt_valid, fg_iou, bg_iou, allow_low_quality=True)
    mi = m.clamp_min(0)
    labels = torch.where(m >= 0, torch.gather(gt_labels.long(), 1, mi),
                         torch.where(m == -1, torch.zeros_like(m), torch.full_like(m, -1)))
    fl = sigmoid_focal_loss(cls_logits.reshape(b * n, c), labels.reshape(-1), gamma,
                            alpha).reshape(b, n, c)
    pos = labels > 0
    n_pos = pos.sum(1).clamp_min(1).to(cls_logits.dtype)
    matched = torch.gather(gt, 1, mi[..., None].expand(-1, -1, 4))
    regt = box_coder.encode4(matched, anchors.expand(b, -1, -1))
    box_l = (smooth_l1(box_deltas - regt, beta=reg_beta) * pos[..., None]).sum((1, 2)) / n_pos
    return (fl.sum((1, 2)) / n_pos).mean(), box_l.mean() * reg_weight / 4.0


def retinanet_postprocess_batched(
    anchors: torch.Tensor,  # (N, 4)
    cls_logits: torch.Tensor,  # (B, N, C)
    box_deltas: torch.Tensor,  # (B, N, 4)
    image_hw: Tuple[int, int],
    pre_nms_top_n: int = 1000,
    score_thresh: float = 0.05,
    nms_thresh: float = 0.4,
    max_det: int = 100,
) -> Boxes2D:
    """-> Boxes2D (B, max_det) with "scores" and "labels" fields."""
    b = cls_logits.shape[0]
    h, w = image_hw
    best, lbl = torch.sigmoid(cls_logits).max(dim=-1)  # the first maximal class
    k = min(pre_nms_top_n, anchors.shape[0])
    top_s, top_i = topk_scores(best, k)
    d = torch.gather(box_deltas, 1, top_i[..., None].expand(-1, -1, 4))
    boxes = box_coder.decode4(d.reshape(-1, 4), anchors[top_i].reshape(-1, 4)).reshape(b, k, 4)
    lims = torch.tensor([w - 1.0, h - 1.0, w - 1.0, h - 1.0], device=boxes.device)
    boxes = torch.clamp(boxes, torch.zeros(4, device=boxes.device), lims)
    idx, kept = nms_topk_batched(boxes, top_s, top_s > score_thresh, nms_thresh, max_det)
    labels = torch.gather(lbl + 1, 1, top_i)
    return Boxes2D(xyxy=torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), valid=kept,
                   size=(w, h), fields={"scores": torch.gather(top_s, 1, idx),
                                        "labels": torch.gather(labels, 1, idx)})
