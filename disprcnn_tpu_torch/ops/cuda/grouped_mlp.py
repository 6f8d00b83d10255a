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
fallback. That launch is forward only (``build.forward_only``). The kernel
runs the chain's products on the tensor cores (wgmma, csrc/mlp_wgmma.cuh)
at float32 accuracy through error-compensated TF32 (each operand split as
hi + lo by ``split_tf32``, each product lo*hi + hi*lo + hi*hi);
``grouped_mlp_max_3xtf32_plain`` is the plain version in that arithmetic.
Its weights are split and laid out as the kernel's shared-memory image by
one launch before it (``pack_wgmma_chain_cuda``, whose plain version is
``pack_wgmma_chain``), in chunks of the launch plan's width
(``launch_plan``).

A bf16 x (a bf16 model's SA-off route) follows the TPU kernel
(grouped_mlp.py:26-40): the affine x * mul0 + add0 and the ReLU in float32,
rounded to bf16, then the chain on bf16 weights with float32 sums, each
layer rounded to bf16, and the max; bf16 out. Its plain version is
``grouped_mlp_max_bf16_plain``; on the card it launches the kernel's bf16
form, ``grouped_mlp_max_bf16_cuda`` (the same kernel body on bf16 tiles:
one wgmma bf16 product a k16 step, no split), counted in
``launches_bf16``. Its weights are rounded to bf16 and laid out by
``pack_wgmma_chain_bf16_cuda`` (plain version ``pack_wgmma_chain_bf16``),
its plan from ``launch_plan(..., bf16=True)``. Each form raises on the
other's dtype: nothing is cast to reach a kernel.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import build
from .conv3d import split_tf32
from .sa import BF16, MAX_LAYERS, _check, mlp_chain, mlp_chain_3xtf32, mlp_chain_bf16

# Launches of the CUDA kernel in this process, and of its bf16 form; a
# caller may reset them to 0 around a run it wants to count.
launches = 0
launches_bf16 = 0

# a group fits in one consumer warpgroup's 64 rows
MAX_S = 64
# the packed weights are padded to this in K and N: a slab of the kernel's
# weight ring holds this many K values (csrc/mlp_wgmma.cuh kSlabK) of a
# chunk of 128 or 64 output columns (CHUNKS, the launch plan's choice)
SLAB_K = 32
CHUNKS = (128, 64)
# the plain version works on chunks of at most this many activations of
# its widest layer
PLAIN_CHUNK_ELEMS = 1 << 27

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _lib() -> ctypes.CDLL:
    lib = build.load("grouped_mlp")
    if lib.grouped_mlp_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for sfx in ("", "_bf16"):
            getattr(lib, f"grouped_mlp{sfx}_cuda").argtypes = [p, p, p, p, p, p, i, i, i, p, p,
                                                               p, i]
            getattr(lib, f"grouped_mlp{sfx}_plan").argtypes = [p, i, i, p]
            getattr(lib, f"grouped_mlp{sfx}_pack_cuda").argtypes = [p, p, i, i, p, p, i]
        lib.grouped_mlp_packed_floats.argtypes = [p, i]
        lib.grouped_mlp_bf16_packed_words.argtypes = [p, i]
        for fn in (lib.grouped_mlp_cuda, lib.grouped_mlp_plan, lib.grouped_mlp_packed_floats,
                   lib.grouped_mlp_pack_cuda, lib.grouped_mlp_bf16_cuda,
                   lib.grouped_mlp_bf16_plan, lib.grouped_mlp_bf16_packed_words,
                   lib.grouped_mlp_bf16_pack_cuda):
            fn.restype = i
        lib.grouped_mlp_error_string.argtypes = [i]
        lib.grouped_mlp_error_string.restype = ctypes.c_char_p
    return lib


def _check_layers(weights: Weights) -> None:
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"need 1 to {MAX_LAYERS} layers after the input affine, got "
                         f"{len(weights)}")


def grouped_mlp_max_plain(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                          weights: Weights, chain: Optional[Callable] = None) -> torch.Tensor:
    """x (G, S, C0), mul0 and add0 (C0,), weights [(W (Ci, Co), b (Co,))]
    -> (G, C_last). `chain` (x, weights) -> activations runs the layers
    (mlp_chain by default)."""
    _check_layers(weights)
    g, s, c0 = x.shape
    widest = max([c0] + [w.shape[1] for w, _ in weights])
    step = max(1, PLAIN_CHUNK_ELEMS // (s * widest))
    outs = [(chain or mlp_chain)(torch.relu(x[lo:lo + step] * mul0 + add0), weights).amax(dim=1)
            for lo in range(0, g, step)]
    return torch.cat(outs, 0)


def grouped_mlp_max_3xtf32_plain(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                                 weights: Weights) -> torch.Tensor:
    """grouped_mlp_max_plain with each product of the chain in the kernel's
    3xTF32 arithmetic (sa.py::mlp_chain_3xtf32)."""
    return grouped_mlp_max_plain(x, mul0, add0, weights, chain=mlp_chain_3xtf32)


def grouped_mlp_max_bf16_plain(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                               weights: Weights) -> torch.Tensor:
    """The bf16 form's plain version: x (G, S, C0) bf16, the affine and ReLU
    in float32 rounded to bf16, the chain in mlp_chain_bf16's arithmetic,
    the max over each group -> (G, C_last) bf16 (mul0, add0 and the weights
    float32)."""
    _check_layers(weights)
    g, s, c0 = x.shape
    widest = max([c0] + [w.shape[1] for w, _ in weights])
    step = max(1, PLAIN_CHUNK_ELEMS // (s * widest))
    outs = [mlp_chain_bf16(torch.relu(x[lo:lo + step].float() * mul0 + add0).to(BF16),
                           weights).amax(dim=1)
            for lo in range(0, g, step)]
    return torch.cat(outs, 0)


def _pad(c: int) -> int:
    return -(-c // SLAB_K) * SLAB_K


def pack_wgmma_chain(weights: Weights, nc: int) -> torch.Tensor:
    """The chain's weights as csrc/grouped_mlp.cu's kernel reads them into
    shared memory: per layer W (Ci, Co) padded with zeros to (Kp, Np), both
    multiples of SLAB_K, split by split_tf32; cut into chunks of nc (one
    of CHUNKS) output columns (the last one narrower), each chunk into slabs of SLAB_K rows
    of K; a slab is its hi image then its lo image, an image (K8 = 4 k8
    steps, NCW / 8 column groups, 2 K halves, 8 columns, 4 K values) for
    chunk width NCW: wgmma's K-major layout without swizzle, core matrices
    of 8 columns x 4 K values. The layers, chunks and slabs one after the
    other. The plain version of the kernel's own packing,
    pack_wgmma_chain_cuda."""
    parts = []
    for w, _ in weights:
        ci, co = w.shape
        kp, np_ = _pad(ci), _pad(co)
        hi, lo = split_tf32(torch.nn.functional.pad(w, (0, np_ - co, 0, kp - ci)))
        for n0 in range(0, np_, nc):
            ncw = min(nc, np_ - n0)

            def image(t):
                # (slab, kk, half, k4, n8, row) -> (slab, kk, n8, half, row, k4)
                return (t[:, n0:n0 + ncw].reshape(kp // SLAB_K, SLAB_K // 8, 2, 4, ncw // 8, 8)
                        .permute(0, 1, 4, 2, 5, 3).reshape(kp // SLAB_K, -1))
            parts.append(torch.cat((image(hi), image(lo)), dim=1).reshape(-1))
    return torch.cat(parts)


def pack_wgmma_chain_bf16(weights: Weights, nc: int) -> torch.Tensor:
    """The chain's weights as the kernel's bf16 form reads them into shared
    memory, int32 words of two bf16 (the lower K value in the lower half):
    per layer W (Ci, Co) padded with zeros to (Kp, Np), both multiples of
    SLAB_K, rounded to bf16 (nearest even); cut into chunks of nc output
    columns (the last one narrower), each chunk into slabs of SLAB_K rows
    of K; a slab one image (2 k16 steps, NCW / 8 column groups, 2 K halves,
    8 columns, 8 K values): wgmma's K-major layout without swizzle, core
    matrices of 8 columns x 8 K values (16-byte rows, as the float32 form's
    of 4 TF32 values). The plain version of pack_wgmma_chain_bf16_cuda."""
    parts = []
    for w, _ in weights:
        ci, co = w.shape
        kp, np_ = _pad(ci), _pad(co)
        wb = torch.nn.functional.pad(w, (0, np_ - co, 0, kp - ci)).to(BF16)
        for n0 in range(0, np_, nc):
            ncw = min(nc, np_ - n0)
            # (slab, kk, half, k8, n8, row) -> (slab, kk, n8, half, row, k8)
            parts.append(wb[:, n0:n0 + ncw].reshape(kp // SLAB_K, SLAB_K // 16, 2, 8, ncw // 8, 8)
                         .permute(0, 1, 4, 2, 5, 3).reshape(-1))
    return torch.cat(parts).contiguous().view(torch.int32)


def _chans(weights: Weights, c0: int):
    chans = [c0] + [w.shape[1] for w, _ in weights]
    return (ctypes.c_int * len(chans))(*chans), len(weights)


def launch_plan(chans: Sequence[int], s: int, bf16: bool = False) -> Tuple[int, int, int, int]:
    """The kernel's launch plan (its bf16 form's with `bf16`) for the
    chain's widths chans (C0, ..., C_last) and groups of s rows: (consumer
    warpgroups, chunk width nc, ring slots, shared memory bytes). Raises if
    no plan fits a block's shared memory."""
    lib = _lib()
    carr = (ctypes.c_int * len(chans))(*chans)
    plan = (ctypes.c_int * 4)()
    fn = lib.grouped_mlp_bf16_plan if bf16 else lib.grouped_mlp_plan
    err = fn(carr, len(chans) - 1, s, plan)
    if err != 0:
        raise ValueError(f"grouped_mlp: no launch plan for widths {tuple(chans)} and S={s}: "
                         f"{lib.grouped_mlp_error_string(err).decode()}")
    return tuple(plan)


def pack_wgmma_chain_cuda(weights: Weights, nc: int, bf16: bool = False) -> torch.Tensor:
    """pack_wgmma_chain(weights, nc), or with `bf16`
    pack_wgmma_chain_bf16(weights, nc), in one launch of
    csrc/grouped_mlp.cu's packing on the current stream (each W float32,
    contiguous, on one card; 1 to MAX_LAYERS layers)."""
    if nc not in CHUNKS:
        raise ValueError(f"nc must be one of {CHUNKS}, got {nc}")
    _check_layers(weights)
    dev = weights[0][0].device
    cin = weights[0][0].shape[0]
    for i, (w, _) in enumerate(weights):
        _check(f"weights[{i}]", w, (cin, w.shape[1]), dev)
        cin = w.shape[1]
    lib = _lib()
    carr, nl = _chans(weights, weights[0][0].shape[0])
    wptr = (ctypes.c_void_p * nl)(*[w.data_ptr() for w, _ in weights])
    if bf16:
        out = torch.empty(lib.grouped_mlp_bf16_packed_words(carr, nl), dtype=torch.int32,
                          device=dev)
        fn, name = lib.grouped_mlp_bf16_pack_cuda, "grouped_mlp_bf16_pack_cuda"
    else:
        out = torch.empty(lib.grouped_mlp_packed_floats(carr, nl), device=dev)
        fn, name = lib.grouped_mlp_pack_cuda, "grouped_mlp_pack_cuda"
    err = fn(wptr, carr, nl, nc, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
             dev.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.grouped_mlp_error_string(err).decode()}")
    return out


def pack_for_launch(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """The packed weights that a launch of the kernel (its bf16 form for a
    bf16 x) on x (G, S, C0) reads: the weight packing each launch runs
    first."""
    bf16 = x.dtype == BF16
    plan = launch_plan([x.shape[2]] + [w.shape[1] for w, _ in weights], x.shape[1], bf16)
    return pack_wgmma_chain_cuda(weights, plan[1], bf16)


def grouped_mlp_max_cuda(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                         weights: Weights) -> torch.Tensor:
    """Launch csrc/grouped_mlp.cu on the current stream; same contract as
    grouped_mlp_max_plain. Every tensor float32, contiguous, on one card."""
    global launches
    build.forward_only("grouped_mlp_max_cuda", x, mul0, add0,
                       *(t for pair in weights for t in pair))
    out = _launch(x, mul0, add0, weights, torch.float32)
    launches += 1
    return out


def grouped_mlp_max_bf16_cuda(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                              weights: Weights) -> torch.Tensor:
    """Launch the bf16 form of csrc/grouped_mlp.cu on the current stream;
    same contract as grouped_mlp_max_bf16_plain. x bf16, every other tensor
    float32, all contiguous, on one card."""
    global launches_bf16
    build.forward_only("grouped_mlp_max_bf16_cuda", x, mul0, add0,
                       *(t for pair in weights for t in pair))
    out = _launch(x, mul0, add0, weights, BF16)
    launches_bf16 += 1
    return out


def _launch(x, mul0, add0, weights, dtype) -> torch.Tensor:
    """One launch of the kernel in the form of `dtype` (x and the output of
    that dtype), not counted."""
    if not x.is_cuda:
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    _check_layers(weights)
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be (G, S, C0), got {tuple(x.shape)}")
    g, s, c0 = x.shape
    _check("x", x, (g, s, c0), dev, dtype)
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
    bf16 = dtype == BF16
    plan = launch_plan(chans, s, bf16)
    wpk = pack_wgmma_chain_cuda(weights, plan[1], bf16)
    out = torch.empty((g, chans[-1]), dtype=dtype, device=dev)
    nl = len(weights)
    bptr = (ctypes.c_void_p * nl)(*[bias.data_ptr() for _, bias in weights])
    carr = (ctypes.c_int * len(chans))(*chans)
    parr = (ctypes.c_int * 4)(*plan)
    name = "grouped_mlp_bf16_cuda" if bf16 else "grouped_mlp_cuda"
    err = getattr(lib, name)(x.data_ptr(), mul0.data_ptr(), add0.data_ptr(), wpk.data_ptr(),
                             bptr, carr, nl, g, s, parr, out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.grouped_mlp_error_string(err).decode()}")
    return out


def grouped_mlp_max(x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                    weights: Weights) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; a bf16 x takes
    the bf16 form (kernel or plain version)."""
    if x.dtype == BF16:
        if x.is_cuda:
            return grouped_mlp_max_bf16_cuda(x, mul0, add0, weights)
        return grouped_mlp_max_bf16_plain(x, mul0, add0, weights)
    if x.is_cuda:
        return grouped_mlp_max_cuda(x, mul0, add0, weights)
    return grouped_mlp_max_plain(x, mul0, add0, weights)
