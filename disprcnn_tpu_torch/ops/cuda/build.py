"""Build the port's CUDA sources with plain nvcc and load them with ctypes.

Each ``disprcnn_tpu_torch/csrc/<name>.cu`` has a plain C interface and
becomes ``csrc/build/lib<name>-<hash>.so``, built at first use. The hash
covers the source, the headers beside it (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and a stale library is never loaded. No PyTorch headers are compiled: a build takes
seconds, not the minutes of ``torch.utils.cpp_extension.load``.

``build(*names)`` compiles the missing libraries, one nvcc process per
source, all started together; ``load(name)`` builds if needed and returns
the loaded library. ``forward_only`` guards the wrappers whose outputs
ctypes writes: such an output has no ``grad_fn``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
# every kernel source of the port, in the order chip_smoke.py builds them
SOURCES = ("nms", "conv3d", "conv3d_tc", "conv_bf16_wgmma", "cost_volume_tc", "softargmin",
           "fps", "sa", "grouped_mlp", "fp", "roipool3d")
# -Xptxas -v only reports registers and shared memory. No fast math: the
# kernels keep IEEE division, exp and denormals.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per source: nms.cu must be bit-equal to its plain PyTorch version (one
# flipped ulp at the IoU threshold changes the kept set), so it forbids the
# contraction of a * b + c into one rounding. The convolutions and the
# soft-argmin are held to tolerances and keep the fused multiply-add.
EXTRA_FLAGS: Dict[str, tuple] = {"nms": ("--fmad=false",)}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> Dict[str, str]:
    """Compile csrc/<name>.cu for each name that is not built, one nvcc per
    source, all running at once. Returns nvcc's diagnostics (ptxas resource
    usage) by name, empty for a library that was already built; raises if
    any nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    texts = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        texts[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{texts[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return texts


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def forward_only(what: str, *tensors) -> None:
    """Raise if autograd would need a gradient through `what`'s output: a
    kernel launched through ctypes records nothing for the backward pass,
    so a gradient would silently stop there. The train path calls the
    kernels through torch.autograd.Function wrappers (conv3d_train,
    sa_ball_mlp_max_train), whose forward runs with grad mode off."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward: run it under torch.no_grad() or "
                           f"through its train form")
