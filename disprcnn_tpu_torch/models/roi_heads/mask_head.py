"""Mask head on the left view (counterpart of
disprcnn_tpu/models/roi_heads/mask_head.py; reference
modeling/roi_heads/mask_head/).

14x14 pooling, four 3x3 convs + ReLU, a 2x2/2 transposed conv + ReLU and a
1x1 conv to num_classes logits at 28x28; inference takes the sigmoid of the
predicted label's channel. The loss (loss.py:44-141) is BCE-with-logits of
the matched class's channel against the matched GT mask cropped to the ROI
and thresholded at 0.5, averaged over the positive rows' pixels.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import sum_over_ranks
from ...structures.masks import crop_and_resize_mask
from .pooler import fpn_roi_align


class MaskHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 2,
                 conv_dims: Sequence[int] = (256, 256, 256, 256), resolution: int = 14,
                 scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
                 sampling_ratio: int = 2):
        super().__init__()
        self.resolution = resolution
        self.scales = tuple(scales)
        self.sampling_ratio = sampling_ratio
        self.num_convs = len(conv_dims)
        cin = in_channels
        for i, dim in enumerate(conv_dims):
            self.add_module(f"fcn{i + 1}", nn.Conv2d(cin, dim, 3, padding=1))
            cin = dim
        self.deconv = nn.ConvTranspose2d(cin, cin, 2, stride=2)
        self.mask_logits = nn.Conv2d(cin, num_classes, 1)

    def forward(self, feats, boxes: torch.Tensor, batch_idx: torch.Tensor) -> torch.Tensor:
        """(N, 4) left boxes -> (N, num_classes, 2r, 2r) logits."""
        x = fpn_roi_align(feats, boxes, batch_idx, self.scales, self.resolution,
                          self.sampling_ratio)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"fcn{i + 1}")(x))
        return self.mask_logits(F.relu(self.deconv(x)))


def mask_probs(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(P, C, 2r, 2r), (P,) -> (P, 2r, 2r) sigmoid of the label channel."""
    lbl = labels.clamp_min(0).long()
    idx = lbl[:, None, None, None].expand(-1, 1, *mask_logits.shape[2:])
    return torch.sigmoid(torch.gather(mask_logits, 1, idx)[:, 0])


def mask_loss(mask_logits: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
              pos: torch.Tensor, gt_masks: torch.Tensor, matched_gt: torch.Tensor
              ) -> torch.Tensor:
    """mask_logits (P, C, 2r, 2r); boxes (P, 4) left ROIs; labels (P,)
    matched class; pos (P,) bool; gt_masks (N, H, W) full-image masks;
    matched_gt (P,) index into them -> the mean BCE over the positive rows."""
    out_size = mask_logits.shape[-1]
    t = (crop_and_resize_mask(gt_masks, matched_gt, boxes, out_size) > 0.5).to(
        mask_logits.dtype)
    lbl = labels.clamp_min(0).long()
    idx = lbl[:, None, None, None].expand(-1, 1, *mask_logits.shape[2:])
    logit = torch.gather(mask_logits, 1, idx)[:, 0]
    bce = logit.clamp_min(0) - logit * t + torch.log1p(torch.exp(-logit.abs()))
    w = pos[:, None, None].to(logit.dtype)
    return (bce * w).sum() / (sum_over_ranks(w.sum()) * out_size * out_size).clamp_min(1.0)
