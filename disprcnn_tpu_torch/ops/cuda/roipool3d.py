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
``roipool3d_cuda``, looked up at call time. There is no fallback. That
launch is forward only (``build.forward_only``). The kernel writes its
rows on one of two routes, both hand-written: "bulk" (chunks of rows
staged in shared memory and written by TMA bulk stores), wherever its
ring of chunks fits in shared memory, else "direct" (each row stored from
registers); ``_launch(..., route=...)`` forces one.

A bf16 model's features come in two parts (``roipool3d_bf16``): E float32
channels (the RCNN's seg mask and depth, float32 as the JAX concat gives
them) and C bf16 channels (the RPN's features); each row is [xyz, the
float32 channels, the bf16 channels widened], float32, bit-equal to the
float32 form on the widened features (the TPU kernel's bf16 channels ride
its gather exactly). On the card it launches csrc/roipool3d.cu's bf16 form
(``roipool3d_bf16_cuda``, counted in ``launches_bf16``), which widens in
the gather, so no float32 copy of the features is made; its plain version
``roipool3d_bf16_plain`` widens them and takes the float32 plain version.

The train form ``roipool3d_train`` (the RCNN and RPN trained in one step,
where the pooled points and features carry the RPN's gradient) is a
``torch.autograd.Function``: the same kernel as its forward (launch point
``roipool3d_train_cuda``), and as its backward ``roipool3d_backward_plain``,
which recomputes each box's sampled points by the plain version's rule
and adds each slot's gradient to its point's row (``scatter_add_``, the
backward of the plain version's gather); an empty box sends none. The
JAX package's fused kernel has no VJP: its train step differentiates the
plain gather route (disprcnn_tpu/ops/roipool3d.py), as this backward does.
On bf16 features, ``roipool3d_train_bf16``: the forward is the bf16 read's
kernel (launch point ``roipool3d_train_bf16_cuda``, counted in
``train_launches_bf16``), the backward the same float32 scatter-add, whose
columns of the bf16 features are rounded once to bf16: in JAX the gather
reads them widened to float32 (the concat's promotion), so their gradient
is the float32 sum converted back to bf16.
"""
from __future__ import annotations

import ctypes

import torch

from ..roipool3d import _first_k_cycled_rows, pts_in_boxes3d, roipool3d_plain
from . import build
from .sa import _check

__all__ = ["roipool3d", "roipool3d_cuda", "roipool3d_plain", "roipool3d_train",
           "roipool3d_train_cuda", "roipool3d_backward_plain", "roipool3d_bf16",
           "roipool3d_bf16_cuda", "roipool3d_bf16_plain", "roipool3d_train_bf16",
           "roipool3d_train_bf16_cuda"]

# Launches of the CUDA kernel in this process, by the eval wrapper, by the
# train form's forward and by the bf16 form; a caller may reset them to 0
# around a run it wants to count.
launches = 0
train_launches = 0
launches_bf16 = 0
train_launches_bf16 = 0

BF16 = torch.bfloat16

MAX_S = 8192
# the kernel's routes by the number its C interface takes (0: its own plan)
ROUTES = {"bulk": 1, "direct": 2}


def _lib() -> ctypes.CDLL:
    lib = build.load("roipool3d")
    if lib.roipool3d_cuda.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.roipool3d_cuda.argtypes = [p, p, p, p, i, i, i, i, i, f, i, p, p, p, i]
        lib.roipool3d_cuda.restype = i
        lib.roipool3d_bf16_cuda.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, p, p, p, i]
        lib.roipool3d_bf16_cuda.restype = i
        lib.roipool3d_error_string.argtypes = [i]
        lib.roipool3d_error_string.restype = ctypes.c_char_p
    return lib


def _launch(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
            sampled_pts_num: int = 512, max_dis: float = 10.0, route: str = None,
            bf16_feats: torch.Tensor = None):
    """Launch csrc/roipool3d.cu on the current stream on `route` ("bulk",
    "direct", or None: the kernel's plan); same contract as
    roipool3d_plain. Every tensor float32, contiguous, on one card; with
    `bf16_feats` (B, N, C) bf16 the bf16 form, `feats` then the E float32
    channels that come first. The callers count the launch."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got {route!r}")
    build.forward_only("roipool3d_cuda", pts, feats, bf16_feats)
    if not pts.is_cuda:
        raise ValueError(f"pts must be on a CUDA device, got {pts.device}")
    dev = pts.device
    b, n = pts.shape[:2]
    m, e = boxes3d.shape[1], feats.shape[-1]
    c = e if bf16_feats is None else bf16_feats.shape[-1]
    _check("pts", pts, (b, n, 3), dev)
    _check("feats", feats, (b, n, e), dev)
    if bf16_feats is not None:
        _check("bf16_feats", bf16_feats, (b, n, c), dev, BF16)
    _check("boxes3d", boxes3d, (b, m, 7), dev)
    if not (1 <= sampled_pts_num <= MAX_S and 1 <= b <= 65535 and n >= 1 and m >= 1):
        raise ValueError(f"need 1 <= S <= {MAX_S}, 1 <= B <= 65535, N, M >= 1; got "
                         f"S={sampled_pts_num} B={b} N={n} M={m}")
    ry = boxes3d[..., 6]
    cossin = torch.stack([torch.cos(ry), torch.sin(ry)], dim=-1).contiguous()
    lib = _lib()
    width = 3 + e + (0 if bf16_feats is None else c)
    out = torch.empty((b, m, sampled_pts_num, width), device=dev)
    empty = torch.empty((b, m), dtype=torch.bool, device=dev)
    tail = (float(max_dis), ROUTES.get(route, 0), out.data_ptr(), empty.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if bf16_feats is None:
        err = lib.roipool3d_cuda(pts.data_ptr(), feats.data_ptr(), boxes3d.data_ptr(),
                                 cossin.data_ptr(), b, n, m, c, sampled_pts_num, *tail)
        name = "roipool3d_cuda"
    else:
        err = lib.roipool3d_bf16_cuda(pts.data_ptr(), feats.data_ptr(), bf16_feats.data_ptr(),
                                      boxes3d.data_ptr(), cossin.data_ptr(), b, n, m, e, c,
                                      sampled_pts_num, *tail)
        name = "roipool3d_bf16_cuda"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.roipool3d_error_string(err).decode()}")
    return out, empty


def roipool3d_cuda(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
                   sampled_pts_num: int = 512, max_dis: float = 10.0):
    """Launch csrc/roipool3d.cu on the route its plan picks from the
    shapes; same contract as roipool3d_plain."""
    global launches
    out = _launch(pts, feats, boxes3d, sampled_pts_num, max_dis)
    launches += 1
    return out


def roipool3d(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
              sampled_pts_num: int = 512, max_dis: float = 10.0):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if pts.is_cuda:
        return roipool3d_cuda(pts, feats, boxes3d, sampled_pts_num, max_dis)
    return roipool3d_plain(pts, feats, boxes3d, sampled_pts_num, max_dis)


def roipool3d_bf16_plain(pts: torch.Tensor, extra: torch.Tensor, feats: torch.Tensor,
                         boxes3d: torch.Tensor, sampled_pts_num: int = 512,
                         max_dis: float = 10.0):
    """The bf16 form's plain version: pts (B, N, 3) and extra (B, N, E)
    float32, feats (B, N, C) bf16 -> roipool3d_plain of [extra, feats
    widened to float32] (pooled (B, M, S, 3 + E + C) float32, empty)."""
    return roipool3d_plain(pts, torch.cat([extra, feats.float()], dim=-1), boxes3d,
                           sampled_pts_num, max_dis)


def roipool3d_bf16_cuda(pts: torch.Tensor, extra: torch.Tensor, feats: torch.Tensor,
                        boxes3d: torch.Tensor, sampled_pts_num: int = 512,
                        max_dis: float = 10.0):
    """Launch csrc/roipool3d.cu's bf16 form (the bf16 channels widened in
    the gather); same contract as roipool3d_bf16_plain."""
    global launches_bf16
    out = _launch(pts, extra, boxes3d, sampled_pts_num, max_dis, bf16_feats=feats)
    launches_bf16 += 1
    return out


def roipool3d_bf16(pts: torch.Tensor, extra: torch.Tensor, feats: torch.Tensor,
                   boxes3d: torch.Tensor, sampled_pts_num: int = 512, max_dis: float = 10.0):
    """The bf16 form: kernel for CUDA tensors, plain version for CPU
    tensors."""
    if pts.is_cuda:
        return roipool3d_bf16_cuda(pts, extra, feats, boxes3d, sampled_pts_num, max_dis)
    return roipool3d_bf16_plain(pts, extra, feats, boxes3d, sampled_pts_num, max_dis)


def roipool3d_train_cuda(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
                         sampled_pts_num: int = 512, max_dis: float = 10.0):
    """The train form's forward: the kernel, on tensors without autograd."""
    global train_launches
    out = _launch(pts, feats, boxes3d, sampled_pts_num, max_dis)
    train_launches += 1
    return out


def roipool3d_backward_plain(pts: torch.Tensor, boxes3d: torch.Tensor, grad: torch.Tensor,
                             sampled_pts_num: int = 512, max_dis: float = 10.0):
    """The gradient of roipool3d's pooled rows: pts (B, N, 3), boxes (B, M,
    7), grad (B, M, S, 3 + C) -> the gradient of [xyz, features] (B, N, 3 +
    C): every slot's row added to the point it sampled (the first-k-cycled
    rule of the plain version, recomputed), nothing from an empty box."""
    b, n = pts.shape[:2]
    m, c = boxes3d.shape[1], grad.shape[-1]
    mask = pts_in_boxes3d(pts, boxes3d, max_dis)
    idx, cnt = _first_k_cycled_rows(mask.reshape(b * m, n), sampled_pts_num)
    grad = torch.where((cnt == 0).reshape(b, m, 1, 1), torch.zeros_like(grad), grad)
    out = torch.zeros((b, n, c), dtype=grad.dtype, device=grad.device)
    return out.scatter_add_(1, idx.reshape(b, m * sampled_pts_num, 1).expand(-1, -1, c),
                            grad.reshape(b, m * sampled_pts_num, c))


class _RoIPool3dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, feats, boxes3d, sampled_pts_num, max_dis):
        ctx.save_for_backward(pts, boxes3d)
        ctx.sampled_pts_num, ctx.max_dis = sampled_pts_num, max_dis
        pooled, empty = roipool3d_train_cuda(pts, feats, boxes3d, sampled_pts_num, max_dis)
        ctx.mark_non_differentiable(empty)
        return pooled, empty

    @staticmethod
    def backward(ctx, dpooled, _):
        pts, boxes3d = ctx.saved_tensors
        full = roipool3d_backward_plain(pts, boxes3d, dpooled.contiguous(), ctx.sampled_pts_num,
                                        ctx.max_dis)
        dpts = full[..., :3] if ctx.needs_input_grad[0] else None
        dfeats = full[..., 3:] if ctx.needs_input_grad[1] else None
        return dpts, dfeats, None, None, None


def roipool3d_train(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
                    sampled_pts_num: int = 512, max_dis: float = 10.0):
    """roipool3d, differentiable in pts and feats (the boxes only decide
    which points a box takes: no gradient). CUDA tensors take the kernel
    forward and roipool3d_backward_plain's backward, CPU tensors the plain
    version."""
    if pts.is_cuda:
        return _RoIPool3dTrain.apply(pts, feats, boxes3d, int(sampled_pts_num), float(max_dis))
    return roipool3d_plain(pts, feats, boxes3d, sampled_pts_num, max_dis)


def roipool3d_train_bf16_cuda(pts: torch.Tensor, extra: torch.Tensor, feats: torch.Tensor,
                              boxes3d: torch.Tensor, sampled_pts_num: int = 512,
                              max_dis: float = 10.0):
    """The bf16 train form's forward: the bf16 read's kernel, on tensors
    without autograd."""
    global train_launches_bf16
    out = _launch(pts, extra, boxes3d, sampled_pts_num, max_dis, bf16_feats=feats)
    train_launches_bf16 += 1
    return out


class _RoIPool3dTrainBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, extra, feats, boxes3d, sampled_pts_num, max_dis):
        ctx.save_for_backward(pts, boxes3d)
        ctx.sampled_pts_num, ctx.max_dis, ctx.e = sampled_pts_num, max_dis, extra.shape[-1]
        pooled, empty = roipool3d_train_bf16_cuda(pts, extra, feats, boxes3d, sampled_pts_num,
                                                  max_dis)
        ctx.mark_non_differentiable(empty)
        return pooled, empty

    @staticmethod
    def backward(ctx, dpooled, _):
        pts, boxes3d = ctx.saved_tensors
        full = roipool3d_backward_plain(pts, boxes3d, dpooled.contiguous(), ctx.sampled_pts_num,
                                        ctx.max_dis)
        need = ctx.needs_input_grad
        e = 3 + ctx.e
        return (full[..., :3] if need[0] else None, full[..., 3:e] if need[1] else None,
                full[..., e:].to(torch.bfloat16) if need[2] else None, None, None, None)


def roipool3d_train_bf16(pts: torch.Tensor, extra: torch.Tensor, feats: torch.Tensor,
                         boxes3d: torch.Tensor, sampled_pts_num: int = 512,
                         max_dis: float = 10.0):
    """roipool3d_bf16, differentiable in pts, extra and the bf16 feats (the
    module doc). CUDA tensors take the kernel forward and the scatter-add
    backward, CPU tensors the plain version (autograd of its gather)."""
    if pts.is_cuda:
        return _RoIPool3dTrainBF16.apply(pts, extra, feats, boxes3d, int(sampled_pts_num),
                                         float(max_dis))
    return roipool3d_bf16_plain(pts, extra, feats, boxes3d, sampled_pts_num, max_dis)
