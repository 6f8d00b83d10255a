"""The grouped MLP + max (row 12, csrc/grouped_mlp.cu) on the card at the
SA-off route's eight sites of a headline request, whole (chip_smoke.py's
GM_SITES): device ms a launch (bench.time_ms with the launches queued),
the weight packing's share, the error against the plain float32 version
and against the chain in float64, and the sum over the sites.

    python -m disprcnn_tpu_torch.tools.profile_grouped_mlp [TREE ...]

With TREE arguments (checkouts of the repo, e.g. a parent commit unpacked
under the git-ignored .archive/), each tree's own package is timed in a
process of its own, in the order given, through its
``grouped_mlp_max_cuda(x, mul0, add0, weights)``; without, this checkout's.
The last line of each tree's output is a JSON object {"tree", "sites":
{site: ms}, "total_ms"}. Needs a CUDA card; prints the card's name and
power limit first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

# (site, groups G, S, C0, chain after the input affine), as chip_smoke.py
SITES = (("RPN SA1 scale 0", 65536, 16, 64, (64, 128)),
         ("RPN SA1 scale 1", 65536, 32, 64, (96, 128)),
         ("RPN SA2 scale 0", 32768, 16, 128, (196, 256)),
         ("RPN SA2 scale 1", 32768, 32, 128, (196, 256)),
         ("RPN SA3 scale 0", 8192, 16, 256, (256, 512)),
         ("RPN SA3 scale 1", 8192, 32, 256, (384, 512)),
         ("RCNN SA0", 262144, 64, 128, (128, 128)),
         ("RCNN SA1", 65536, 64, 128, (128, 256)))
REPS = 5
TREE_TIMEOUT_S = 400  # a tree's process is stopped after this long


def inputs(gen, g, s, c0, chain):
    import torch

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, mul0, add0 = randn(g, s, c0), 1 + randn(c0, scale=0.3), randn(c0, scale=0.1)
    ws, cin = [], c0
    for co in chain:
        ws.append((randn(cin, co, scale=cin ** -0.5), randn(co, scale=0.1)))
        cin = co
    return x, mul0, add0, ws


def float64_max(x, mul0, add0, ws):
    """The function with every product and sum in float64, the groups 4096
    at a time."""
    import torch
    outs = []
    for lo in range(0, x.shape[0], 4096):
        y = torch.relu(x[lo:lo + 4096].double() * mul0.double() + add0.double())
        for w, b in ws:
            y = torch.relu(y @ w.double() + b.double())
        outs.append(y.amax(dim=1))
    return torch.cat(outs)


def measure() -> dict:
    """This process's package at the sites: -> {"sites": {site: ms}, ...}."""
    import torch
    import disprcnn_tpu_torch
    from disprcnn_tpu_torch.bench import card_line, max_err, time_ms
    from disprcnn_tpu_torch.ops.cuda import grouped_mlp as cgm

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    print(f"package {os.path.dirname(disprcnn_tpu_torch.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    sites, total = {}, 0.0
    pack = getattr(cgm, "pack_for_launch", None)
    with torch.inference_mode():
        for site, g, s, c0, chain in SITES:
            args = inputs(gen, g, s, c0, chain)
            got = cgm.grouped_mlp_max_cuda(*args)
            want = cgm.grouped_mlp_max_plain(*args)
            err = max_err(got, want, f"row 12 {site}")
            exact = float64_max(*args)
            scale = float(exact.abs().max())
            e_kernel = float((got.double() - exact).abs().max()) / scale
            e_plain = float((want.double() - exact).abs().max()) / scale
            del got, want, exact
            ms = time_ms(lambda: cgm.grouped_mlp_max_cuda(*args), REPS, queued=True)
            pack_ms = (time_ms(lambda: pack(args[0], args[3]), REPS, queued=True)
                       if pack else None)
            sites[site] = ms
            total += ms
            flops = 2.0 * g * s * sum(ci * co for ci, co in zip((c0,) + chain, chain))
            extra = "" if pack_ms is None else f", of it packing {pack_ms:.4f} ms"
            print(f"  {site} (G {g}, S {s}, {c0} -> {' -> '.join(map(str, chain))}): "
                  f"{ms:.4f} ms{extra}, {flops / ms / 1e9:.1f} TFLOP/s; max |diff| {err:.3g}; "
                  f"against float64: kernel {e_kernel:.3g}, plain {e_plain:.3g} of max |exact|",
                  flush=True)
            del args
            torch.cuda.empty_cache()
    print(f"  sum over the {len(SITES)} sites: {total:.4f} ms", flush=True)
    return {"sites": sites, "total_ms": total}


def main() -> None:
    trees = sys.argv[1:]
    if not trees:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card")
        print(json.dumps({"tree": ".", **measure()}), flush=True)
        return
    failed = []
    for tree in trees:
        path = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=path)
        code = (f"import sys, json; sys.path.insert(0, {path!r}); "
                f"sys.path.insert(1, {os.path.dirname(os.path.abspath(__file__))!r}); "
                f"import profile_grouped_mlp as p; "
                f"print(json.dumps({{'tree': {tree!r}, **p.measure()}}), flush=True)")
        print(f"== {tree}", flush=True)
        try:
            res = subprocess.run([sys.executable, "-c", code], env=env, cwd=path,
                                 timeout=TREE_TIMEOUT_S)
            if res.returncode != 0:
                failed.append(f"{tree}: exit {res.returncode}")
        except subprocess.TimeoutExpired:
            failed.append(f"{tree}: no result in {TREE_TIMEOUT_S} s")
    if failed:
        raise SystemExit("; ".join(failed))


if __name__ == "__main__":
    main()
