"""Greedy 2D NMS that emits the first k survivors, and the 3D proposals'
BEV NMS (counterparts of the 2D top-k forms and of ``bev_nms_mask`` and
``topk_after_nms`` in disprcnn_tpu/ops/nms.py).

``bev_nms_mask(..., rotated=True)`` (RPN.NMS_TYPE "rotate") is the JAX
package's XLA route, not a TPU kernel, and is plain PyTorch here: the
rotated BEV IoU of every pair in score order, then the greedy decisions
as the fixpoint of keep = valid & ~any(keep_j & iou_ji > thresh, j < i)
(``greedy_keep``), iterated from keep = valid, at most N passes, which the
greedy answer is the one fixpoint of. The passes run in blocks of
FIXPOINT_BLOCK between the host's convergence checks (one sync a block,
not one a box); ``rotated_stats`` counts calls, passes and syncs.

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
from .iou import pairwise_bev_iou

_NEG = -1e10
FIXPOINT_BLOCK = 8  # fixpoint passes between two convergence checks
IOU_PAIRS_CHUNK = 1 << 17  # rotated IoU pairs evaluated at once (~10 KB of temporaries each)
# the rotated route's calls, fixpoint passes and host syncs in this process
rotated_stats = {"calls": 0, "passes": 0, "syncs": 0}


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


def pairwise_bev_iou_chunked(bev: torch.Tensor) -> torch.Tensor:
    """(B, N, 5) -> (B, N, N) rotated BEV IoU of each image's pairs,
    evaluated IOU_PAIRS_CHUNK pairs (whole rows) at a time."""
    b, n = bev.shape[:2]
    out = bev.new_empty((b, n, n))
    rows = max(1, min(b * n, IOU_PAIRS_CHUNK // max(n, 1)))
    flat_out = out.reshape(b * n, n)
    for r0 in range(0, b * n, rows):
        r1 = min(r0 + rows, b * n)
        img = torch.arange(r0, r1, device=bev.device) // n
        a = bev.reshape(b * n, 5)[r0:r1]
        flat_out[r0:r1] = pairwise_bev_iou(a[:, None], bev[img])[:, 0]
    return out


def greedy_keep(iou: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy suppression over score-ordered (B, N, N) IoUs -> keep (B, N)
    in that order: box i is kept iff it is valid and no earlier kept box
    overlaps it by more than thresh (strict >), as the JAX package's
    ``_greedy_keep``, by its fixpoint iteration."""
    n = iou.shape[-1]
    tri = torch.ones((n, n), dtype=torch.bool, device=iou.device).tril(-1)  # j < i
    sup = (iou > thresh) & tri & valid[:, None, :]
    keep = valid
    rotated_stats["calls"] += 1
    passes = 0
    while passes < n:
        block = min(FIXPOINT_BLOCK, n - passes)
        for _ in range(block):
            prev, keep = keep, valid & ~(sup & keep[:, None, :]).any(-1)
        passes += block
        rotated_stats["passes"] += block
        rotated_stats["syncs"] += 1
        if torch.equal(keep, prev):
            break
    return keep


def bev_nms_mask(bev_boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                 iou_thresh: float, rotated: bool = False) -> torch.Tensor:
    """Greedy NMS of (B, N, 5) BEV boxes (x1, y1, x2, y2, ry) -> keep (B, N)
    bool in the original order, suppression at IoU > thresh, ties by
    index. rotated=False is the JAX ``bev_nms_mask(rotated=False)``
    (RPN.NMS_TYPE "normal"): ry ignored, the axis-aligned IoU without the
    +1 term (reference iou3d nms_normal_gpu), on the NMS kernel for CUDA
    tensors; rotated=True the rotated-rectangle IoU (reference iou3d
    nms_gpu) with ``greedy_keep``."""
    b, n = scores.shape
    if rotated:
        key = torch.where(valid, scores, torch.full_like(scores, _NEG))
        order = torch.sort(key, dim=-1, descending=True, stable=True).indices
        bo = torch.gather(bev_boxes, 1, order[..., None].expand(-1, -1, 5))
        keep_sorted = greedy_keep(pairwise_bev_iou_chunked(bo), torch.gather(valid, 1, order),
                                  iou_thresh)
        return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
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
