"""Device time of each kernel launch inside the cost-volume conv (row 2:
the weight packing, the tap planes, their sums) and the transposed conv
(row 5: the packing, the conv) at the main path's shapes (128 ROIs,
quarter-resolution 56^2 features, 24 disparity slices; the hourglass's
14^2 -> 28^2 and 28^2 -> 56^2 sites), from torch.profiler, beside each
wrapper call's time from CUDA events. Then the classifier's 32 -> 1 conv
(row 4) at the main path's (128, 32, 24, 56, 56), from CUDA events: the
kernel, its copies alone and its arithmetic alone (csrc/conv3d.cu's study
modes), one read of its input (a sum), and its bound. Random inputs from a
seeded generator, float32.

    python -m disprcnn_tpu_torch.tools.profile_convs

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ..bench import card_line
from ..ops.cuda import build
from ..ops.cuda import conv3d as cconv

REPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM's memory rate, as chip_smoke.py's bounds
CL1_MODES = {0: "kernel", 1: "copies alone", 2: "arithmetic alone"}


def event_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int = REPS) -> dict:
    """Device ms per call of each kernel that fn() launches, by name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]:
            e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def cl1_study(x: torch.Tensor, weight: torch.Tensor, mode: int) -> torch.Tensor:
    """csrc/conv3d.cu's kernel in one of CL1_MODES, identity affine."""
    lib = build.load("conv3d")
    fn = lib.conv3d_cl1_study_cuda
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, i, i, p, p, p, p, i, p, p, i, i]
    fn.restype = i
    n, ci, d, h, w = x.shape
    wt = F.pad(weight.reshape(ci, 27), (0, 1))
    one, zero = torch.ones(1, device=x.device), torch.zeros(1, device=x.device)
    out = torch.empty(n, 1, d, h, w, device=x.device)
    err = fn(x.data_ptr(), n, ci, d, h, w, wt.data_ptr(), one.data_ptr(), zero.data_ptr(),
             None, 0, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
             x.device.index, mode)
    if err:
        raise RuntimeError(f"conv3d_cl1_study_cuda mode {mode}: cudaError {err}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_convs: no CUDA device")
    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def affine(co):
        return 1 + randn(co, scale=0.3), randn(co, scale=0.1)

    left, right = randn(128, 32, 56, 56), randn(128, 32, 56, 56)
    w2, (m2, a2) = randn(32, 64, 3, 3, 3, scale=0.05), affine(32)
    calls = {"row 2, cost volume (128, 32, 56, 56) x2, D 24":
             lambda: cconv.cost_volume_conv_bn_cuda(left, right, w2, m2, a2, -12, 12)}
    for ci, co, d, s, relu in ((64, 64, 6, 14, True), (64, 32, 12, 28, False)):
        x, w, (m, a) = randn(128, ci, d, s, s), randn(ci, co, 3, 3, 3, scale=0.05), affine(co)
        res = randn(128, co, 2 * d, 2 * s, 2 * s)
        calls[f"row 5, transposed conv {s}^2 -> {2 * s}^2, {ci} -> {co}"] = (
            lambda x=x, w=w, m=m, a=a, res=res, relu=relu:
            cconv.deconv3d_bn_cuda(x, w, m, a, res, relu))
    with torch.inference_mode():
        for name, fn in calls.items():
            parts = ", ".join(f"{k} {v:.4f} ms" for k, v in kernel_ms(fn).items())
            print(f"{name}: {event_ms(fn):.4f} ms a call (events); per launch: {parts}",
                  flush=True)
        x, weight = randn(128, 32, 24, 56, 56), randn(1, 32, 3, 3, 3, scale=0.05)
        want = cconv.conv3d_bn_cuda(x, weight)
        if not torch.equal(cl1_study(x, weight, 0), want):
            raise AssertionError("row 4 study: mode 0 is not the kernel")
        bound = (x.numel() + want.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        parts = ", ".join(f"{label} {event_ms(lambda m=m: cl1_study(x, weight, m)):.4f} ms"
                          for m, label in CL1_MODES.items())
        print(f"row 4, classifier conv {tuple(x.shape)} -> 1: {parts}; its input read once "
              f"(a sum) {event_ms(lambda: x.sum()):.4f} ms; bound {bound:.4f} ms (bytes)",
              flush=True)


if __name__ == "__main__":
    main()
