"""The 3D RPN over per-instance pseudo-LiDAR clouds and its proposal layer,
eval only (counterpart of disprcnn_tpu/models/pointrcnn/rpn3d.py;
reference lib/net/rpn.py, rpn/proposal_layer.py).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ...ops.iou import boxes3d_to_bev
from ...ops.nms import bev_nms_mask, topk_after_nms
from ...ops.topk_select import topk_scores
from . import bbox3d_codec as codec
from .pointnet2 import BN_EPS, SA_MIN_C0, Pointnet2MSG, batch_norm_eval


class ConvHead(nn.Module):
    """Per-point dense head: fc{i} (+ BN) + ReLU per hidden width, then
    ``out``. Dropout is the identity at eval."""

    def __init__(self, hidden: Sequence[int], out: int, in_channels: int, use_bn: bool = True):
        super().__init__()
        self.hidden, self.use_bn = tuple(hidden), use_bn
        cin = in_channels
        for i, c in enumerate(self.hidden):
            setattr(self, f"fc{i}", nn.Linear(cin, c, bias=not use_bn))
            if use_bn:
                setattr(self, f"bn{i}", nn.BatchNorm1d(c, eps=BN_EPS))
            cin = c
        self.out = nn.Linear(cin, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hidden)):
            x = getattr(self, f"fc{i}")(x)
            if self.use_bn:
                x = batch_norm_eval(getattr(self, f"bn{i}"), x)
            x = torch.relu(x)
        return self.out(x)


class RPN3D(nn.Module):
    """PointNet++ backbone + per-point classification and box regression."""

    def __init__(self, codec_cfg: codec.CodecCfg = codec.CodecCfg(),
                 cls_fc: Sequence[int] = (128,), reg_fc: Sequence[int] = (128,),
                 use_bn: bool = True, npoints: Sequence[int] = (4096, 1024, 256, 64),
                 sa_min_c0: int = SA_MIN_C0, kernels_off=frozenset()):
        super().__init__()
        self.backbone = Pointnet2MSG(npoints=npoints, use_bn=use_bn, sa_min_c0=sa_min_c0,
                                     kernels_off=kernels_off)
        c = self.backbone.out_channels
        self.cls_head = ConvHead(cls_fc, 1, c, use_bn)
        self.reg_head = ConvHead(reg_fc, codec_cfg.reg_channels, c, use_bn)

    def forward(self, pts: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pts (R, N, 3) -> xyz (R, N, 3), features (R, N, C), per-point cls
        (R, N) and reg (R, N, reg_channels)."""
        xyz, feats = self.backbone(pts)
        return {"xyz": xyz, "features": feats, "cls": self.cls_head(feats)[..., 0],
                "reg": self.reg_head(feats)}


def propose(cls_pred: torch.Tensor, reg_pred: torch.Tensor, xyz: torch.Tensor,
            anchor_size: torch.Tensor, cfg: codec.CodecCfg, pre_nms_top_n: int,
            post_nms_top_n: int,
            nms_thresh: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score-based proposals (reference score_based_proposal): decode every
    point's box with its y moved to the bottom face, keep the pre-NMS top-k
    scores (ties by index), axis-aligned BEV NMS (RPN.NMS_TYPE "normal"),
    then the post-NMS top-k.
    -> (rois (R, post, 7), scores (R, post), valid (R, post))."""
    r, n = cls_pred.shape
    boxes = codec.decode(xyz.reshape(r * n, 3), reg_pred.reshape(r * n, -1), anchor_size,
                         cfg).reshape(r, n, 7)
    boxes = torch.cat([boxes[..., :1], boxes[..., 1:2] + boxes[..., 3:4] / 2, boxes[..., 2:]],
                      dim=-1)
    k = min(pre_nms_top_n, n)
    top_s, top_i = topk_scores(cls_pred, k)
    b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 7))
    keep = bev_nms_mask(boxes3d_to_bev(b), top_s, torch.ones_like(top_s, dtype=torch.bool),
                        nms_thresh)
    idx, ok = topk_after_nms(keep, top_s, post_nms_top_n)
    return (torch.gather(b, 1, idx[..., None].expand(-1, -1, 7)), torch.gather(top_s, 1, idx),
            ok)
