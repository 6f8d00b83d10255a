"""PSMNet's eval regression head: align-corners trilinear upsample of the
cost logits, softmax over disparity, expected disparity. The CUDA kernel's
wrapper and its plain PyTorch version (counterparts of
disprcnn_tpu/ops/pallas/softargmin.py:fused_softargmin and of the plain
``regress`` in disprcnn_tpu/models/psmnet/psmnet.py:1000-1020).

``softargmin`` dispatches: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel (csrc/softargmin.cu), whose one launch point is
``softargmin_cuda``, looked up at call time. There is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

# Launches of the CUDA kernel in this process; a caller may reset it to 0
# around a run it wants to count.
launches = 0

# the kernel keeps one pixel's D4 bilinear values in a thread
MAX_D4 = 64


def _lib() -> ctypes.CDLL:
    lib = build.load("softargmin")
    if lib.softargmin_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.softargmin_cuda.argtypes = [p, i, i, i, i, i, i, i, i, p, p, i]
        lib.softargmin_cuda.restype = i
        lib.softargmin_error_string.argtypes = [i]
        lib.softargmin_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def interp_matrix_align_corners(n_in: int, n_out: int, device=None,
                                dtype=torch.float32) -> torch.Tensor:
    """(n_out, n_in) linear-interpolation matrix with align_corners=True
    semantics, positions o * (n_in - 1) / (n_out - 1) in float32
    (psmnet.py:_interp_matrix_align_corners), returned in `dtype` on
    `device`. It is built on the CPU: PyTorch on CUDA divides by a scalar as
    a multiply by its reciprocal, one ulp off the division for some
    positions, which moves the expected disparity by up to ~1e-3 px. Each
    matrix is built and copied once per (sizes, device, dtype) and shared:
    callers must not modify it. It is a normal tensor even when first asked
    for under inference mode."""
    with torch.inference_mode(False):
        if n_in == 1:
            return torch.ones((n_out, 1), device=device, dtype=dtype)
        pos = torch.arange(n_out, dtype=torch.float32) * (n_in - 1) / max(n_out - 1, 1)
        i0 = torch.floor(pos).long().clamp(0, n_in - 2)
        frac = pos - i0
        rows = torch.arange(n_out)
        m = torch.zeros((n_out, n_in))
        m[rows, i0] = 1.0 - frac
        m[rows, i0 + 1] = frac
        return m.to(device=device, dtype=dtype)


def softargmin_plain(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
                     maxdisp: int) -> torch.Tensor:
    """logits (B, D4, h4, w4) -> (B, H, W) expected disparity: upsample D,
    then H, then W by matrix contractions, softmax over D, expectation."""
    _, d4, h4, w4 = logits.shape
    h, w = out_hw
    dev, dt = logits.device, logits.dtype
    c = torch.einsum("bdhw,ed->behw", logits,
                     interp_matrix_align_corners(d4, maxdisp - mindisp, dev, dt))
    c = torch.einsum("bdhw,eh->bdew", c, interp_matrix_align_corners(h4, h, dev, dt))
    c = torch.einsum("bdhw,ew->bdhe", c, interp_matrix_align_corners(w4, w, dev, dt))
    p = torch.softmax(c, dim=1)
    disp = torch.arange(mindisp, maxdisp, dtype=p.dtype, device=dev)
    return torch.einsum("bdhw,d->bhw", p, disp)


def softargmin_cuda(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
                    maxdisp: int) -> torch.Tensor:
    """Launch csrc/softargmin.cu on the current stream; same contract as
    softargmin_plain."""
    global launches
    build.forward_only("softargmin_cuda", logits)
    if logits.dim() != 4 or logits.dtype != torch.float32 or not logits.is_cuda:
        raise ValueError(f"logits must be (B, D4, h4, w4) float32 on CUDA, got "
                         f"{tuple(logits.shape)} {logits.dtype} on {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    b, d4, h4, w4 = logits.shape
    h, w = out_hw
    if d4 > MAX_D4 or maxdisp <= mindisp:
        raise ValueError(f"need D4 <= {MAX_D4} and maxdisp > mindisp, got D4={d4} "
                         f"[{mindisp}, {maxdisp})")
    lib = _lib()
    out = torch.empty((b, h, w), device=logits.device)
    err = lib.softargmin_cuda(
        logits.data_ptr(), b, d4, h4, w4, h, w, mindisp, maxdisp, out.data_ptr(),
        torch.cuda.current_stream(logits.device).cuda_stream, logits.device.index)
    if err != 0:
        raise RuntimeError(f"softargmin_cuda launch failed: "
                           f"{lib.softargmin_error_string(err).decode()}")
    launches += 1
    return out


def softargmin(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
               maxdisp: int) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if logits.is_cuda:
        return softargmin_cuda(logits, out_hw, mindisp, maxdisp)
    return softargmin_plain(logits, out_hw, mindisp, maxdisp)
