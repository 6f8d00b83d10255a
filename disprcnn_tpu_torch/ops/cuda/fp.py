"""PointNet++ feature propagation with skip features: the CUDA kernel's
wrapper and its plain PyTorch version (counterparts of
disprcnn_tpu/ops/pallas/fp_fused.py:fp_fused and of the XLA FPModule path
in disprcnn_tpu/models/pointrcnn/pointnet2.py).

For each target point: its 3 nearest source points (ties to the lowest
index), inverse-distance weights 1 / (d + eps) normalized over the three,
the interpolated source features concatenated with the target's skip
features, then the folded-BN chain x = relu(x W + b) per layer.

``fp_fused`` dispatches: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel (csrc/fp.cu), whose one launch point is
``fp_fused_cuda``, looked up at call time. There is no fallback. The
kernel runs the chain's products on the tensor cores at float32 accuracy
through error-compensated TF32 (csrc/mlp_tc.cuh, the set-abstraction
kernel's chain); its weights are split and laid out by one launch of the
SA kernel's packing before it (``sa.pack_tf32_chain_cuda``).
``fp_fused_3xtf32_plain`` is the plain version with the chain in that
arithmetic.

The bf16 form (a bf16 model's) follows the TPU kernel
(fp_fused.py:_kernel, :25-72): the known and skip features bf16; the
neighbours and their weights in float32 as above; the known features
gathered exactly and interpolated in float32 in JAX's order, ((w0 / wsum)
f0 + (w1 / wsum) f1) + (w2 / wsum) f2, then rounded to bf16; the
concatenation with the skip features and the chain on bf16 weights, each
layer bf16(relu(x W + b)) with float32 sums; bf16 out. ``fp_fused``
dispatches on the known features' dtype: bf16 takes ``fp_fused_bf16_cuda``
on the card (csrc/fp.cu's bf16 form, weights packed by
``sa.pack_bf16_chain_cuda``; counted in ``launches_bf16``) and
``fp_fused_bf16_plain`` on the CPU. Each form raises on the other's dtype.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..points import three_interpolate, three_nn, three_nn_interpolate_weights
from . import build
from .sa import (BF16, MAX_LAYERS, Weights, _check, mlp_chain, mlp_chain_3xtf32, mlp_chain_bf16,
                 pack_bf16_chain_cuda, pack_tf32_chain_cuda)

# Launches of the CUDA kernel in this process, and of its bf16 form; a
# caller may reset them to 0 around a run it wants to count.
launches = 0
launches_bf16 = 0

# the kernel keeps a cloud's source points in shared memory
MAX_NS = 4096


def _lib() -> ctypes.CDLL:
    lib = build.load("fp")
    if lib.fp_cuda.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.fp_cuda, lib.fp_bf16_cuda):
            fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, f, p, p, i]
            fn.restype = i
        lib.fp_error_string.argtypes = [i]
        lib.fp_error_string.restype = ctypes.c_char_p
    return lib


def fp_fused_plain(unknown: torch.Tensor, known: torch.Tensor, known_feats: torch.Tensor,
                   unknown_feats: torch.Tensor, weights: Weights, eps: float = 1e-8,
                   chain: Optional[Callable] = None) -> torch.Tensor:
    """unknown (B, Nt, 3), known (B, Ns, 3), known_feats (B, Ns, C),
    unknown_feats (B, Nt, Cs), weights [(W (Ci, Co), b (Co,))] with the first
    Ci = C + Cs -> (B, Nt, C_last). `chain` (x, weights) -> activations runs
    the layers (mlp_chain by default)."""
    d, idx = three_nn(unknown, known)
    interp = three_interpolate(known_feats, idx, three_nn_interpolate_weights(d, eps))
    return (chain or mlp_chain)(torch.cat([interp, unknown_feats], dim=-1), weights)


def fp_fused_3xtf32_plain(unknown, known, known_feats, unknown_feats, weights,
                          eps: float = 1e-8) -> torch.Tensor:
    """fp_fused_plain with the chain in the kernel's 3xTF32 arithmetic
    (mlp_chain_3xtf32: each product lo*hi + hi*lo + hi*hi of operands split
    by split_tf32). The kernel makes the first layer's input in chunks of
    128 columns; the chunks' products are summed in one running sum, so the
    chunking changes no value."""
    return fp_fused_plain(unknown, known, known_feats, unknown_feats, weights, eps,
                          chain=mlp_chain_3xtf32)


def fp_fused_bf16_plain(unknown: torch.Tensor, known: torch.Tensor, known_feats: torch.Tensor,
                        unknown_feats: torch.Tensor, weights: Weights, eps: float = 1e-8,
                        chain: Optional[Callable] = None) -> torch.Tensor:
    """The bf16 form's plain version: as fp_fused_plain with the features
    bf16 and the TPU kernel's roundings (the module doc) -> (B, Nt, C_last)
    bf16. `chain` (x, weights) -> activations runs the layers
    (mlp_chain_bf16 by default)."""
    d, idx = three_nn(unknown, known)
    interp = three_interpolate(known_feats, idx, three_nn_interpolate_weights(d, eps))
    x = torch.cat([interp.to(BF16), unknown_feats], dim=-1)
    return (chain or mlp_chain_bf16)(x, weights)


def _fp_launch(unknown, known, known_feats, unknown_feats, weights, eps, bf16: bool):
    """One launch of the FP kernel (its bf16 form: the features and the
    output bf16), its weights packed first; not counted."""
    build.forward_only("fp_fused_cuda", known_feats, unknown_feats,
                       *(t for pair in weights for t in pair))
    if not unknown.is_cuda:
        raise ValueError(f"unknown must be on a CUDA device, got {unknown.device}")
    dev = unknown.device
    b, nt = unknown.shape[:2]
    ns = known.shape[1]
    c, cs = known_feats.shape[-1], unknown_feats.shape[-1]
    ft = BF16 if bf16 else torch.float32
    _check("unknown", unknown, (b, nt, 3), dev)
    _check("known", known, (b, ns, 3), dev)
    _check("known_feats", known_feats, (b, ns, c), dev, ft)
    _check("unknown_feats", unknown_feats, (b, nt, cs), dev, ft)
    chans = [c + cs]
    for i, (w, bias) in enumerate(weights):
        _check(f"weights[{i}]", w, (chans[-1], w.shape[1]), dev)
        _check(f"bias[{i}]", bias, (w.shape[1],), dev)
        chans.append(w.shape[1])
    if not 1 <= len(weights) <= MAX_LAYERS or not 3 <= ns <= MAX_NS or not 1 <= b <= 65535:
        raise ValueError(f"need 1..{MAX_LAYERS} layers, 3 <= Ns <= {MAX_NS} and B <= 65535, "
                         f"got {len(weights)} layers, Ns={ns}, B={b}")
    lib = _lib()
    wpk = (pack_bf16_chain_cuda if bf16 else pack_tf32_chain_cuda)(weights)
    out = torch.empty((b, nt, chans[-1]), dtype=ft, device=dev)
    nl = len(weights)
    bptr = (ctypes.c_void_p * nl)(*[bias.data_ptr() for _, bias in weights])
    carr = (ctypes.c_int * len(chans))(*chans)
    fn, name = (lib.fp_bf16_cuda, "fp_bf16_cuda") if bf16 else (lib.fp_cuda, "fp_cuda")
    err = fn(unknown.data_ptr(), known.data_ptr(), known_feats.data_ptr(),
             unknown_feats.data_ptr(), wpk.data_ptr(), bptr, carr, nl, b, nt, ns, c, cs,
             float(eps), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.fp_error_string(err).decode()}")
    return out


def fp_fused_cuda(unknown: torch.Tensor, known: torch.Tensor, known_feats: torch.Tensor,
                  unknown_feats: torch.Tensor, weights: Weights,
                  eps: float = 1e-8) -> torch.Tensor:
    """Launch csrc/fp.cu (its weight packing, then the kernel) on the
    current stream; same contract as fp_fused_plain. Every tensor float32,
    contiguous, on one card."""
    global launches
    out = _fp_launch(unknown, known, known_feats, unknown_feats, weights, eps, bf16=False)
    launches += 1
    return out


def fp_fused_bf16_cuda(unknown: torch.Tensor, known: torch.Tensor, known_feats: torch.Tensor,
                       unknown_feats: torch.Tensor, weights: Weights,
                       eps: float = 1e-8) -> torch.Tensor:
    """Launch csrc/fp.cu's bf16 form; same contract as fp_fused_bf16_plain.
    The features bf16, the points and weights float32, all contiguous, on
    one card."""
    global launches_bf16
    out = _fp_launch(unknown, known, known_feats, unknown_feats, weights, eps, bf16=True)
    launches_bf16 += 1
    return out


def fp_fused(unknown: torch.Tensor, known: torch.Tensor, known_feats: torch.Tensor,
             unknown_feats: torch.Tensor, weights: Weights, eps: float = 1e-8) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; the bf16 form
    for bf16 known features."""
    if known_feats.dtype == BF16:
        fn = fp_fused_bf16_cuda if unknown.is_cuda else fp_fused_bf16_plain
    else:
        fn = fp_fused_cuda if unknown.is_cuda else fp_fused_plain
    return fn(unknown, known, known_feats, unknown_feats, weights, eps)
