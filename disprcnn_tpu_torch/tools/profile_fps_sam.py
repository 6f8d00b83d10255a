"""Furthest-point sampling (row 9, csrc/fps.cu) on the card: both routes
(block, warp) over a grid of cloud counts B at (N, npoint) sites of the
main path and around it, in device time (bench.time_ms with the launches
queued). The data the route threshold (ops/cuda/fps.py BLOCK_ROUTE_MAX_B)
is read from. Seeded random clouds, float32; every launch's indices are
held to the plain version first. The bounds, serial chains and the
soft-argmin's times are chip_smoke.py's phase 9.

    python -m disprcnn_tpu_torch.tools.profile_fps_sam

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import torch

from ..bench import card_line, time_ms
from ..ops.cuda import fps as cfps

REPS = 5
ROUTE_BS = (128, 192, 256, 320, 384, 512, 768, 1024, 2048, 6400)
ROUTE_SITES = ((1024, 512), (768, 512), (512, 128), (256, 64), (128, 32))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("FPS routes, device ms a launch (block, warp; the faster named):")
    for n, npoint in ROUTE_SITES:
        for b in ROUTE_BS:
            xyz = (torch.randn(b, n, 3, generator=gen, device="cuda") * 1.5).contiguous()
            want = cfps.furthest_point_sample_plain(xyz, npoint)
            times = {}
            for route in ("block", "warp"):
                if not torch.equal(cfps._launch(xyz, npoint, route), want):
                    raise AssertionError(f"FPS {route} route != plain at ({b}, {n}, {npoint})")
                times[route] = time_ms(lambda: cfps._launch(xyz, npoint, route), REPS,
                                       queued=True)
            best = min(times, key=times.get)
            print(f"  ({b}, {n} -> {npoint}): block {times['block']:.4f}, warp "
                  f"{times['warp']:.4f}; {best} (the wrapper takes {cfps.fps_route(b, n)})",
                  flush=True)


if __name__ == "__main__":
    main()
