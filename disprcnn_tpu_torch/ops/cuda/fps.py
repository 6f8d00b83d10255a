"""Furthest-point sampling: the CUDA kernel's wrapper and its plain PyTorch
version (counterparts of disprcnn_tpu/ops/pallas/fps.py and of the XLA
``_fps_single`` in disprcnn_tpu/ops/points.py:43-60).

For each (N, 3) cloud: slot 0 is point 0, and step i takes the point with
the largest running minimum of squared distances to the points taken so
far (the minimum starts at 1e10), ties to the lowest index. A squared
distance is ((dx*dx + dy*dy) + dz*dz), each operation rounded on its own.

``furthest_point_sample`` dispatches: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel (csrc/fps.cu), whose one launch point is
``furthest_point_sample_cuda``, looked up at call time. There is no
fallback. The kernel has two routes, both hand-written: a block of
BLOCK_THREADS threads a cloud for a few long clouds, a warp a cloud for
many; ``fps_route`` picks one from B and N. ``_launch`` takes a route
by name, for tests and measurements.
``furthest_point_sample_keys_plain`` is the kernel's argmax on the CPU:
winners by float bits per warp's slice of the points, then across slices
by packed keys.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Launches of the CUDA kernel in this process; a caller may reset it to 0
# around a run it wants to count.
launches = 0

# a lane of the warp route holds at most 32 points in registers
MAX_N = 1024
# threads of a block on the block route (csrc/fps.cu kBlockThreads)
BLOCK_THREADS = 128
# (n0, limit) pairs: B clouds of N points take the block route if B <= the
# limit of the first pair with N > n0, else the warp route (the crossings
# measured on an H100 by tools/profile_fps_sam.py at N = 1024, 768, 512,
# 256 and 128; PERF.md)
BLOCK_ROUTE_MAX_B = ((768, 384), (512, 256), (256, 384), (128, 256), (0, 128))
ROUTES = {"warp": 0, "block": 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("fps")
    if lib.fps_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fps_cuda.argtypes = [p, i, i, i, p, i, p, i]
        lib.fps_cuda.restype = i
        lib.fps_error_string.argtypes = [i]
        lib.fps_error_string.restype = ctypes.c_char_p
    return lib


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances of broadcast (..., 3) points, summed x, y, z in that
    order from direct differences (never the |a|^2 + |b|^2 - 2ab form of
    torch.cdist, which loses ~1e-2 relative accuracy and flips selections)."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int64 indices; a loop of npoint - 1 steps,
    each vectorised over the batch."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    mind = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    last = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    for i in range(1, npoint):
        mind = torch.minimum(mind, sqdist(xyz, xyz[rows, last][:, None, :]))
        last = torch.argmax(mind, dim=1)  # the first of equal maxima
        idx[:, i] = last
    return idx


def fps_route(b: int, n: int) -> str:
    """The kernel's route for B clouds of N points: "block" for a few clouds
    (each spread over a block), "warp" for many (a warp each)."""
    limit = next(lim for n0, lim in BLOCK_ROUTE_MAX_B if n > n0)
    return "block" if b <= limit else "warp"


def furthest_point_sample_keys_plain(xyz: torch.Tensor, npoint: int,
                                     threads: int = BLOCK_THREADS) -> torch.Tensor:
    """furthest_point_sample_plain with the kernel's argmax: point j lies in
    the slice of warp (j % threads) // 32; each step takes each slice's
    largest running minimum by its float bits as an int (a minimum is >= 0,
    so the bits order as the floats do) and the lowest index holding it,
    then the slice winner with the largest key (bits << 32) | (0xffffffff -
    index). threads=BLOCK_THREADS is the block route, threads=32 the warp
    route (one slice)."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    index = torch.arange(n, device=xyz.device)
    slices = ((index % threads) // 32).expand(b, n)
    count = (min(threads, n) + 31) // 32
    mind = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    last = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    low = torch.full((b, count), -2 ** 31, dtype=torch.int64, device=xyz.device)
    for i in range(1, npoint):
        mind = torch.minimum(mind, sqdist(xyz, xyz[rows, last][:, None, :]))
        bits = mind.view(torch.int32).to(torch.int64)
        top = low.scatter_reduce(1, slices, bits, "amax")
        holds = torch.where(bits == top.gather(1, slices), index, n)
        first = torch.full_like(top, n).scatter_reduce(1, slices, holds, "amin")
        keys = (top << 32) | (0xFFFFFFFF - first)
        last = 0xFFFFFFFF - (keys.amax(1) & 0xFFFFFFFF)
        idx[:, i] = last
    return idx


def _launch(xyz: torch.Tensor, npoint: int, route: str) -> torch.Tensor:
    """Launch csrc/fps.cu on `route` ("block" or "warp") on the current
    stream; same contract as furthest_point_sample_plain."""
    global launches
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32 or not xyz.is_cuda:
        raise ValueError(f"xyz must be (B, N, 3) float32 on CUDA, got {tuple(xyz.shape)} "
                         f"{xyz.dtype} on {xyz.device}")
    if not xyz.is_contiguous():
        raise ValueError("xyz must be contiguous")
    b, n, _ = xyz.shape
    if not (b >= 1 and 1 <= npoint <= n <= MAX_N):
        raise ValueError(f"need B >= 1 and 1 <= npoint <= N <= {MAX_N}, got B={b} N={n} "
                         f"npoint={npoint}")
    if route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got {route!r}")
    lib = _lib()
    out = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    err = lib.fps_cuda(xyz.data_ptr(), b, n, npoint, out.data_ptr(), ROUTES[route],
                       torch.cuda.current_stream(xyz.device).cuda_stream, xyz.device.index)
    if err != 0:
        raise RuntimeError(f"fps_cuda launch failed: {lib.fps_error_string(err).decode()}")
    launches += 1
    return out


def furthest_point_sample_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Launch csrc/fps.cu on fps_route's route on the current stream; same
    contract as furthest_point_sample_plain."""
    return _launch(xyz, npoint, fps_route(*xyz.shape[:2]) if xyz.dim() == 3 else None)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if xyz.is_cuda:
        return furthest_point_sample_cuda(xyz, npoint)
    return furthest_point_sample_plain(xyz, npoint)
