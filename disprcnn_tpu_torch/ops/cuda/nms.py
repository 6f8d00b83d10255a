"""Greedy 2D NMS over score-sorted boxes: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of disprcnn_tpu/ops/pallas/nms.py).

Semantics of ``nms_sorted_pallas``: for each row of (B, N) boxes already
sorted by score, the sorted positions of the first k survivors of exact
greedy NMS, suppression at IoU > thresh (strict) with the +1 pixel
convention, ties to the lowest sorted index, and ``(n - 1, False)`` in every
slot past the last survivor.

``nms_sorted`` dispatches: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel (csrc/nms.cu). There is no fallback: a kernel
that fails to build or launch raises.

``iou_above_band_plain`` is the kernel's IoU test, which forms the quotient
only near the threshold; it is held to ``inter / union > thresh`` on the
CPU (tests/test_torch_nms_band.py).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Launches of the CUDA kernel in this process; a caller may reset it to 0
# around a run it wants to count.
launches = 0

# The walk keeps two words a tile of 64 boxes in shared memory (its `removed`
# and `alive` bits: 96 KB at MAX_N) and, where it fits (up to ~9500 boxes a
# pass), a ring of tiles' mask runs; MAX_N is the limit of the kernel this
# one replaced.
MAX_N = 48 * 1024 // 8 * 64
# The kernel's IoU test: inter above union * TH_HI (rounded) is above the
# threshold, below union * TH_LO not, whatever the quotient's rounding; only
# between the two does it divide. Sound where the products stay normal:
# thresholds in [BAND_MIN, 1].
BAND = 2.0 ** -20
BAND_MIN = 2.0 ** -60


def _lib() -> ctypes.CDLL:
    lib = build.load("nms")
    fn = lib.nms_sorted_cuda
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, i, i, i, f, f, p, p, p, p, i]
        fn.restype = ctypes.c_int
        lib.nms_error_string.argtypes = [ctypes.c_int]
        lib.nms_error_string.restype = ctypes.c_char_p
        lib.nms_first_pass_tiles.argtypes = [i, i]
        lib.nms_walk_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    return lib


def walk_routes(n: int, k: int) -> tuple:
    """How the kernel walks N boxes for k survivors: per pass, "staged"
    (the masks' runs by bulk copies into shared memory) or "global" (read
    from global memory where the ring does not fit)."""
    lib = _lib()
    tiles = -(-n // 64)
    r1 = lib.nms_first_pass_tiles(n, k)
    nbuf = ctypes.c_int()
    routes = []
    for t0, t1 in ((0, r1), (r1, tiles)):
        if t0 < t1:
            lib.nms_walk_plan(tiles, t1 - t0, ctypes.byref(nbuf))
            routes.append("staged" if nbuf.value else "global")
    return tuple(routes)


def _check_inputs(boxes: torch.Tensor, valid: torch.Tensor, k: int) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be (B, N, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid must be (B, N) bool, got {tuple(valid.shape)} {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")
    if boxes.shape[1] < 1 or k < 1:
        raise ValueError(f"need N >= 1 and k >= 1, got N={boxes.shape[1]} k={k}")


def band_thresholds(thresh: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(thresh, thresh (1 + BAND), thresh (1 - BAND)) as float32 scalars,
    each product rounded once as the kernel's host code rounds them."""
    t = torch.tensor(thresh, dtype=torch.float32)
    return (t, t * torch.tensor(1.0 + BAND, dtype=torch.float32),
            t * torch.tensor(1.0 - BAND, dtype=torch.float32))


def iou_above_band_plain(inter: torch.Tensor, union: torch.Tensor,
                         thresh: float) -> torch.Tensor:
    """The kernel's test of fl(inter / union) > thresh (csrc/nms.cu
    suppresses), float32: certain above union * th_hi and below union *
    th_lo, the quotient between; the quotient everywhere for thresholds
    outside [BAND_MIN, 1]. -> bool, the shape of inter."""
    t, th_hi, th_lo = band_thresholds(thresh)
    exact = inter / union > t
    if not BAND_MIN <= float(t) <= 1.0:
        return exact
    above, below = inter > th_hi * union, inter < th_lo * union
    return above | (~below & exact)


def nms_sorted_plain(
    boxes: torch.Tensor, valid: torch.Tensor, k: int, thresh: float, to_remove: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select-and-suppress loop of k steps, each vectorised over N; no host
    synchronisation inside the loop. -> (idx (B, k) int64, ok (B, k) bool)."""
    _check_inputs(boxes, valid, k)
    b, n, _ = boxes.shape
    x1, y1, x2, y2 = boxes.unbind(-1)  # (B, N) each
    area = (x2 - x1 + to_remove).clamp_min(0.0) * (y2 - y1 + to_remove).clamp_min(0.0)
    pos = torch.arange(n, device=boxes.device)
    alive = valid.clone()
    out = torch.empty((b, k), dtype=torch.int64, device=boxes.device)
    for i in range(k):
        sel = torch.where(alive, pos, n).amin(dim=1)  # (B,); n where none is left
        found = sel < n
        s = sel.clamp_max(n - 1)[:, None]
        sx1, sy1, sx2, sy2, sarea = (t.gather(1, s) for t in (x1, y1, x2, y2, area))
        w = (torch.minimum(x2, sx2) - torch.maximum(x1, sx1) + to_remove).clamp_min(0.0)
        h = (torch.minimum(y2, sy2) - torch.maximum(y1, sy1) + to_remove).clamp_min(0.0)
        inter = w * h
        iou = inter / (sarea + area - inter).clamp_min(1e-12)
        kill = (pos == sel[:, None]) | ((iou > thresh) & found[:, None])
        alive &= ~kill
        out[:, i] = sel
    ok = out < n
    return out.clamp_max(n - 1), ok


def nms_sorted_cuda(
    boxes: torch.Tensor, valid: torch.Tensor, k: int, thresh: float, to_remove: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/nms.cu on the current stream. -> (idx (B, k) int64,
    ok (B, k) bool)."""
    global launches
    _check_inputs(boxes, valid, k)
    if not boxes.is_cuda:
        raise ValueError(f"nms_sorted_cuda needs CUDA tensors, got {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    b, n, _ = boxes.shape
    if n > MAX_N or b > 65535:
        raise ValueError(f"N={n} exceeds the kernel's shared-memory limit {MAX_N}, or "
                         f"B={b} its grid's 65535")
    lib = _lib()
    tiles = -(-n // 64)
    dev = boxes.device
    # per image: the (row tile, column tile, row) suppression words, the
    # valid bits and the kept rows of each tile, a count and a done flag
    # (csrc/nms.cu nms_sorted_cuda)
    scratch = torch.empty(b * (tiles * tiles * 64 + 2 * tiles + 1), dtype=torch.int64,
                          device=dev)
    idx = torch.empty((b, k), dtype=torch.int64, device=dev)
    ok = torch.empty((b, k), dtype=torch.bool, device=dev)
    err = lib.nms_sorted_cuda(
        boxes.data_ptr(), valid.data_ptr(), b, n, k, float(thresh), float(to_remove),
        scratch.data_ptr(), idx.data_ptr(), ok.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index,
    )
    if err != 0:
        raise RuntimeError(f"nms_sorted_cuda launch failed: {lib.nms_error_string(err).decode()}")
    launches += 1
    return idx, ok


def nms_sorted(
    boxes: torch.Tensor, valid: torch.Tensor, k: int, thresh: float, to_remove: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if boxes.is_cuda:
        return nms_sorted_cuda(boxes, valid, k, thresh, to_remove)
    return nms_sorted_plain(boxes, valid, k, thresh, to_remove)
