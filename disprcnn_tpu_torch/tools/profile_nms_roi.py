"""Greedy NMS (row 1, csrc/nms.cu) and RoI-pool 3D (row 14,
csrc/roipool3d.cu) on the card at every site of both 3D budgets, on the
inputs the main path gives them: the bench's models (random weights from
a seed) answer one request of 8 stereo pairs at the headline and one at
the reference budget, and every launch of the two kernels is recorded.
Each recorded launch is held to its plain version (indices and flags,
rows and flags: exactly), then timed in device time (bench.time_ms with
the launches queued behind a sleeping kernel; the median of 5 runs of 10
launches and their min-max). NMS also gets the sorted position where each
launch's walk stopped (after the k-th survivor, else N) and the device
time of each CUDA kernel of the launch from torch.profiler (and the
SRPN's launch again at more k: the walk's cost a tile); RoI-pool the
rate at which it writes its output, against the card's 3.35 TB/s, and
each of its routes where the wrapper has more than one.

    python -m disprcnn_tpu_torch.tools.profile_nms_roi

Needs a CUDA card; prints the card's name and power limit first. The
per-request bounds, serial floors and stage times are chip_smoke.py's
phases 9 and 10.
"""
from __future__ import annotations

import torch

from .. import bench
from ..bench import BENCH_3D, BUDGETS, CALIB, IMG_HW, card_line, time_ms
from ..engine.inference import predict
from ..ops.cuda import nms as cnms
from ..ops.cuda import roipool3d as croi

PAIRS = 8
REPEATS = 5
REPS = 10
HBM_BYTES_PER_S = 3.35e12


def nms_site(args) -> str:
    """The call site of an NMS launch from its arguments (boxes, valid, k,
    thresh, to_remove): the 3D proposals' BEV NMS takes no +1 term; the
    SRPN runs on its 6000 pre-NMS boxes, the box head on 300 proposals."""
    if args[4] == 0:
        return "3D proposals"
    return "SRPN" if args[0].shape[1] >= 1000 else "box head"


def capture(model2d, model3d, req, budget: str) -> dict:
    """The arguments of every NMS and RoI-pool launch of one request."""
    calls = {"nms": [], "roipool3d": []}
    orig = {"nms": cnms.nms_sorted_cuda, "roipool3d": croi.roipool3d_cuda}

    def recorder(name):
        def record(*args):
            calls[name].append(tuple(a.detach().clone() if torch.is_tensor(a) else a
                                     for a in args))
            return orig[name](*args)
        return record

    bench.set_budget(model3d, budget)
    cnms.nms_sorted_cuda, croi.roipool3d_cuda = recorder("nms"), recorder("roipool3d")
    try:
        with torch.inference_mode():
            predict(model2d, model3d, *req[:4], calib=CALIB, priorities=req[4])
    finally:
        cnms.nms_sorted_cuda, croi.roipool3d_cuda = orig["nms"], orig["roipool3d"]
    torch.cuda.synchronize()
    return calls


def device_ms(fn) -> tuple:
    """Median device ms of a launch over REPEATS runs of REPS queued
    launches, and their (min, max)."""
    runs = sorted(time_ms(fn, REPS, queued=True) for _ in range(REPEATS))
    return runs[len(runs) // 2], (runs[0], runs[-1])


def kernel_split(fn) -> str:
    """Device time a launch of each CUDA kernel that fn launches
    (torch.profiler over REPS calls)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    parts = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and evt.count:
            name = evt.key.replace("(anonymous namespace)::", "").split("(")[0]
            parts.append(f"{name} {us / 1e3 / REPS:.4f} ms")
    return ", ".join(parts) or "no device time in the trace"


def walk_stop(args, out) -> tuple:
    """(max, mean) over the images of the sorted position where the walk
    stopped: after the k-th survivor, or N where fewer survive."""
    n = args[0].shape[1]
    idx, ok = out
    stop = torch.where(ok[:, -1], idx[:, -1] + 1, torch.full_like(idx[:, -1], n))
    return int(stop.max()), float(stop.float().mean())


@torch.inference_mode()
def profile_nms(launches, budget: str) -> None:
    for args in launches:
        got = cnms.nms_sorted_cuda(*args)
        want = cnms.nms_sorted_plain(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"NMS kernel != plain at {nms_site(args)} ({budget})")
        ms, (lo, hi) = device_ms(lambda: cnms.nms_sorted_cuda(*args))
        host = time_ms(lambda: cnms.nms_sorted_cuda(*args), REPS)
        stop, mean = walk_stop(args, got)
        b, n, _ = args[0].shape
        print(f"  nms {budget} {nms_site(args)} (B {b}, N {n}, k {args[2]}, IoU {args[3]}, "
              f"+{args[4]:g}): device {ms:.4f} ms ({lo:.4f}-{hi:.4f}), host {host:.4f} ms; "
              f"walk stopped at {stop} of {n} (mean {mean:.1f}); "
              f"{int(got[1].sum())} kept; {kernel_split(lambda: cnms.nms_sorted_cuda(*args))}",
              flush=True)


@torch.inference_mode()
def walk_sweep(args, ks=(1, 64, 150, 300, 600, 1200)) -> None:
    """One launch's inputs at more k: where the walk stops, and each
    kernel's device time (the walk's cost a tile)."""
    for k in ks:
        a = (args[0], args[1], k, *args[3:])
        stop, _ = walk_stop(a, cnms.nms_sorted_cuda(*a))
        ms, _ = device_ms(lambda: cnms.nms_sorted_cuda(*a))
        print(f"    k {k}: walk stopped at {stop} ({-(-stop // 64)} tiles): device {ms:.4f} ms; "
              f"{kernel_split(lambda: cnms.nms_sorted_cuda(*a))}", flush=True)


@torch.inference_mode()
def profile_roipool(launches, budget: str) -> None:
    routes = getattr(croi, "ROUTES", None)
    for args in launches:
        got = croi.roipool3d_cuda(*args)
        want = croi.roipool3d_plain(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"RoI-pool kernel != plain ({budget})")
        pts, feats, boxes, s = args[:4]
        nbytes = 4 * (pts.numel() + feats.numel() + boxes.numel() + got[0].numel()) \
            + got[1].numel()
        forms = {"wrapper": lambda: croi.roipool3d_cuda(*args)}
        for route in routes or ():
            r_got = croi._launch(*args, route=route)
            if not (torch.equal(r_got[0], want[0]) and torch.equal(r_got[1], want[1])):
                raise AssertionError(f"RoI-pool {route} route != plain ({budget})")
            forms[f"{route} route"] = lambda route=route: croi._launch(*args, route=route)
        del got, want
        for label, fn in forms.items():
            ms, (lo, hi) = device_ms(fn)
            print(f"  roipool3d {budget} {label} ({pts.shape[0]} clouds, N {pts.shape[1]}, "
                  f"{boxes.shape[1]} boxes, C {feats.shape[-1]}, S {s}): device {ms:.4f} ms "
                  f"({lo:.4f}-{hi:.4f}), {nbytes / ms / 1e9:.3f} TB/s against the bytes "
                  f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model2d, model3d = bench.build_models("cuda")
    for seed, budget in enumerate(BUDGETS):
        req = bench.make_request(PAIRS, IMG_HW, PAIRS * BENCH_3D["max_det"],
                                 BENCH_3D["lift_grid"], "cuda", seed)
        calls = capture(model2d, model3d, req, budget)
        print(f"{budget} budget: {len(calls['nms'])} NMS launches, "
              f"{len(calls['roipool3d'])} RoI-pool launches", flush=True)
        profile_nms(calls["nms"], budget)
        if budget == "headline":
            print("  the SRPN's launch at more k:", flush=True)
            walk_sweep(calls["nms"][0])
        profile_roipool(calls["roipool3d"], budget)
        del calls


if __name__ == "__main__":
    main()
