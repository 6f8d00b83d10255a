"""3D RoI pooling: the CUDA kernel's wrapper and its plain PyTorch version
(counterparts of disprcnn_tpu/ops/pallas/roipool3d_fused.py:roipool3d_fused
and of the XLA path of disprcnn_tpu/ops/roipool3d.py:roipool3d).

Per box: the points inside it (ops/roipool3d.py:pts_in_boxes3d), the first
S in scan order with slot j >= cnt taking the (j mod cnt)-th, each slot the
[xyz, features] row of its point, zero rows and an empty flag for a box
with no point. The cosine and sine of each box's yaw are computed once
with PyTorch on the tensors' device and handed to the kernel, so the kernel
tests points with the same values as the plain version on that device.

``roipool3d`` dispatches: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel (csrc/roipool3d.cu), whose one launch point is
``roipool3d_cuda``, looked up at call time. There is no fallback. The
kernel writes its rows on one of two routes, both hand-written: "bulk"
(chunks of rows staged in shared memory and written by TMA bulk stores),
wherever its ring of chunks fits in shared memory, else "direct" (each
row stored from registers); ``_launch(..., route=...)`` forces one.
"""
from __future__ import annotations

import ctypes

import torch

from ..roipool3d import roipool3d_plain
from . import build
from .sa import _check

__all__ = ["roipool3d", "roipool3d_cuda", "roipool3d_plain"]

# Launches of the CUDA kernel in this process; a caller may reset it to 0
# around a run it wants to count.
launches = 0

MAX_S = 8192
# the kernel's routes by the number its C interface takes (0: its own plan)
ROUTES = {"bulk": 1, "direct": 2}


def _lib() -> ctypes.CDLL:
    lib = build.load("roipool3d")
    if lib.roipool3d_cuda.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.roipool3d_cuda.argtypes = [p, p, p, p, i, i, i, i, i, f, i, p, p, p, i]
        lib.roipool3d_cuda.restype = i
        lib.roipool3d_error_string.argtypes = [i]
        lib.roipool3d_error_string.restype = ctypes.c_char_p
    return lib


def _launch(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
            sampled_pts_num: int = 512, max_dis: float = 10.0, route: str = None):
    """Launch csrc/roipool3d.cu on the current stream on `route` ("bulk",
    "direct", or None: the kernel's plan); same contract as
    roipool3d_plain. Every tensor float32, contiguous, on one card."""
    global launches
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got {route!r}")
    build.forward_only("roipool3d_cuda", pts, feats)
    if not pts.is_cuda:
        raise ValueError(f"pts must be on a CUDA device, got {pts.device}")
    dev = pts.device
    b, n = pts.shape[:2]
    m, c = boxes3d.shape[1], feats.shape[-1]
    _check("pts", pts, (b, n, 3), dev)
    _check("feats", feats, (b, n, c), dev)
    _check("boxes3d", boxes3d, (b, m, 7), dev)
    if not (1 <= sampled_pts_num <= MAX_S and 1 <= b <= 65535 and n >= 1 and m >= 1):
        raise ValueError(f"need 1 <= S <= {MAX_S}, 1 <= B <= 65535, N, M >= 1; got "
                         f"S={sampled_pts_num} B={b} N={n} M={m}")
    ry = boxes3d[..., 6]
    cossin = torch.stack([torch.cos(ry), torch.sin(ry)], dim=-1).contiguous()
    lib = _lib()
    out = torch.empty((b, m, sampled_pts_num, 3 + c), device=dev)
    empty = torch.empty((b, m), dtype=torch.bool, device=dev)
    err = lib.roipool3d_cuda(pts.data_ptr(), feats.data_ptr(), boxes3d.data_ptr(),
                             cossin.data_ptr(), b, n, m, c, sampled_pts_num, float(max_dis),
                             ROUTES.get(route, 0), out.data_ptr(), empty.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"roipool3d_cuda launch failed: "
                           f"{lib.roipool3d_error_string(err).decode()}")
    launches += 1
    return out, empty


def roipool3d_cuda(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
                   sampled_pts_num: int = 512, max_dis: float = 10.0):
    """Launch csrc/roipool3d.cu on the route its plan picks from the
    shapes; same contract as roipool3d_plain."""
    return _launch(pts, feats, boxes3d, sampled_pts_num, max_dis)


def roipool3d(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
              sampled_pts_num: int = 512, max_dis: float = 10.0):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if pts.is_cuda:
        return roipool3d_cuda(pts, feats, boxes3d, sampled_pts_num, max_dis)
    return roipool3d_plain(pts, feats, boxes3d, sampled_pts_num, max_dis)
