"""A SharedMLP over grouped activations and the max over each group: the
CUDA kernel's wrapper and its plain PyTorch version (counterparts of
disprcnn_tpu/ops/pallas/grouped_mlp.py:grouped_mlp_max and of the XLA
SharedMLP chain + max in disprcnn_tpu/models/pointrcnn/pointnet2.py).

x (G, S, C0) is the grouped pre-activation of a ball-grouped scale: mlp0
applied and its bias added. For each group

    out[g] = max_s chain(relu(x[g, s] * mul0 + add0))

with mul0/add0 mlp0's folded eval BN (ones and zeros without BN) and the
chain relu(x W + b) per layer, BN folded into W and b.

``grouped_mlp_max`` dispatches: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel (csrc/grouped_mlp.cu), whose one launch
point is ``grouped_mlp_max_cuda``, looked up at call time. There is no
fallback. That launch is forward only (``build.forward_only``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build
from .sa import MAX_LAYERS, _check, mlp_chain

# Launches of the CUDA kernel in this process; a caller may reset it to 0
# around a run it wants to count.
launches = 0

# a group fits in the kernel's largest row tile
MAX_S = 64
# the plain version works on chunks of at most this many activations of
# its widest layer
PLAIN_CHUNK_ELEMS = 1 << 27

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _lib() -> ctypes.CDLL:
    lib = build.load("grouped_mlp")
    if lib.grouped_mlp_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_mlp_cuda.argtypes = [p, p, p, p, p, p, i, i, i, p, p, i]
        lib.grouped_mlp_cuda.restype = i
        lib.grouped_mlp_error_string.argtypes = [i]
        lib.grouped_mlp_error_string.restype = ctypes.c_char_p
    return lib


def _check_layers(weights: Weights) -> None:
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"need 1 to {MAX_LAYERS} layers after the input affine, got "
                         f"{len(weights)}")


def grouped_mlp_max_plain(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                          weights: Weights) -> torch.Tensor:
    """x (G, S, C0), mul0 and add0 (C0,), weights [(W (Ci, Co), b (Co,))]
    -> (G, C_last)."""
    _check_layers(weights)
    g, s, c0 = x.shape
    widest = max([c0] + [w.shape[1] for w, _ in weights])
    step = max(1, PLAIN_CHUNK_ELEMS // (s * widest))
    outs = [mlp_chain(torch.relu(x[lo:lo + step] * mul0 + add0), weights).amax(dim=1)
            for lo in range(0, g, step)]
    return torch.cat(outs, 0)


def grouped_mlp_max_cuda(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                         weights: Weights) -> torch.Tensor:
    """Launch csrc/grouped_mlp.cu on the current stream; same contract as
    grouped_mlp_max_plain. Every tensor float32, contiguous, on one card."""
    global launches
    build.forward_only("grouped_mlp_max_cuda", x, mul0, add0,
                       *(t for pair in weights for t in pair))
    if not x.is_cuda:
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    _check_layers(weights)
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be (G, S, C0), got {tuple(x.shape)}")
    g, s, c0 = x.shape
    _check("x", x, (g, s, c0), dev)
    _check("mul0", mul0, (c0,), dev)
    _check("add0", add0, (c0,), dev)
    chans = [c0]
    for i, (w, bias) in enumerate(weights):
        _check(f"weights[{i}]", w, (chans[-1], w.shape[1]), dev)
        _check(f"bias[{i}]", bias, (w.shape[1],), dev)
        chans.append(w.shape[1])
    if not 1 <= s <= MAX_S or g < 1 or g >= 1 << 31:
        raise ValueError(f"need 1 <= S <= {MAX_S} and 1 <= G < 2^31, got S={s}, G={g}")
    lib = _lib()
    out = torch.empty((g, chans[-1]), device=dev)
    nl = len(weights)
    wptr = (ctypes.c_void_p * nl)(*[w.data_ptr() for w, _ in weights])
    bptr = (ctypes.c_void_p * nl)(*[bias.data_ptr() for _, bias in weights])
    carr = (ctypes.c_int * len(chans))(*chans)
    err = lib.grouped_mlp_cuda(x.data_ptr(), mul0.data_ptr(), add0.data_ptr(), wptr, bptr, carr,
                               nl, g, s, out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"grouped_mlp_cuda launch failed: "
                           f"{lib.grouped_mlp_error_string(err).decode()}")
    launches += 1
    return out


def grouped_mlp_max(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                    weights: Weights) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if x.is_cuda:
        return grouped_mlp_max_cuda(x, mul0, add0, weights)
    return grouped_mlp_max_plain(x, mul0, add0, weights)
