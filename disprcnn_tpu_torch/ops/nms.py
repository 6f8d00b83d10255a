"""Greedy 2D NMS that emits the first k survivors, and the 3D proposals'
BEV NMS (counterparts of the 2D top-k forms and of ``bev_nms_mask`` and
``topk_after_nms`` in disprcnn_tpu/ops/nms.py).

Score-descending greedy suppression with the legacy +1 IoU convention,
suppress when IoU > thresh (reference csrc/cuda/nms.cu), ties broken by
index through a stable sort. Double-view NMS runs on the union of each
left/right pair (reference boxlist_ops.double_view_boxlist_nms).

Every form ends in ``ops.cuda.nms.nms_sorted``: the CUDA kernel for CUDA
tensors at every N (the JAX package's ``N >= 1024 and backend == "tpu"``
gate is a TPU cost rule), the plain version for CPU tensors. Slots past the last survivor hold the last sorted
position with ok False, as the JAX kernel path returns.
"""
from __future__ import annotations

import torch

from ..structures.boxes import union_box
from .cuda.nms import nms_sorted

_NEG = -1e10


def nms_topk_batched(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    valid: torch.Tensor,  # (B, N) bool
    iou_thresh: float,
    k: int,
    to_remove: float = 1.0,
    presorted: bool = False,  # rows already score-descending (out of a top-k)
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (indices (B, k) int64 into N, ok (B, k) bool), score-descending.
    The boxes' gradient stops here: NMS emits indices."""
    boxes = boxes.detach()
    if presorted:
        return nms_sorted(boxes.contiguous(), valid.contiguous(), k, iou_thresh, to_remove)
    key = torch.where(valid, scores, torch.full_like(scores, _NEG))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    bo = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    vo = torch.gather(valid, 1, order)
    pos, ok = nms_sorted(bo, vo, k, iou_thresh, to_remove)
    return torch.gather(order, 1, pos), ok


def nms_topk(
    boxes: torch.Tensor,  # (N, 4)
    scores: torch.Tensor,  # (N,)
    valid: torch.Tensor,  # (N,)
    iou_thresh: float,
    k: int,
    to_remove: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-image nms_topk_batched -> (indices (k,), ok (k,))."""
    idx, ok = nms_topk_batched(boxes[None], scores[None], valid[None], iou_thresh, k,
                               to_remove=to_remove)
    return idx[0], ok[0]


def double_view_nms_topk_batched(
    boxes_left: torch.Tensor,
    boxes_right: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh: float,
    k: int,
    to_remove: float = 1.0,
    presorted: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """nms_topk_batched on the union of each L/R pair (SRPN postprocessor
    NMS); one keep decision for both views."""
    return nms_topk_batched(union_box(boxes_left, boxes_right), scores, valid, iou_thresh,
                            k, to_remove=to_remove, presorted=presorted)


def bev_nms_mask(bev_boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                 iou_thresh: float) -> torch.Tensor:
    """Greedy NMS of (B, N, 5) BEV boxes (x1, y1, x2, y2, ry) -> keep (B, N)
    bool in the original order: the JAX ``bev_nms_mask(rotated=False)``
    (RPN.NMS_TYPE "normal"), which ignores ry and takes the axis-aligned IoU
    without the +1 term (reference iou3d nms_normal_gpu); suppression at
    IoU > thresh, ties by index. The rotated form is not ported yet."""
    b, n = scores.shape
    idx, ok = nms_topk_batched(bev_boxes[..., :4], scores, valid, iou_thresh, n, to_remove=0.0)
    keep = torch.zeros((b, n + 1), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, torch.where(ok, idx, torch.full_like(idx, n)), True)
    return keep[:, :n]


def topk_after_nms(keep: torch.Tensor, scores: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to k kept boxes by score, (B, N) -> (indices (B, k), valid (B, k));
    the slots past the kept boxes hold the lowest non-kept indices, as
    XLA's top_k orders the tied _NEG scores."""
    masked = torch.where(keep, scores, torch.full_like(scores, _NEG))
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[:, :k], top[:, :k] > _NEG / 2
