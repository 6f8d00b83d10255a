"""One whole PointNet++ set-abstraction scale: the CUDA kernel's wrapper
and its plain PyTorch version (counterparts of
disprcnn_tpu/ops/pallas/sa_fused.py:sa_ball_mlp_max and of the XLA
factored SharedMLP path in disprcnn_tpu/models/pointrcnn/pointnet2.py).

For each centre: ball query (the first S points strictly within the
radius, in index order; a partial ball repeats its first neighbour, an
empty one takes point 0), then

    x0 = relu((v[idx] + ((gx*w0x[0] + gy*w0x[1]) + gz*w0x[2])) * mul0 + add0)

with (gx, gy, gz) the neighbour minus the centre in float32 and v mlp0's
feature columns applied at the source points plus its bias; then the
folded chain x = relu(x W + b) per layer, and the max over the ball.

``sa_ball_mlp_max`` dispatches: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel (csrc/sa.cu), whose one launch point is
``sa_ball_mlp_max_cuda``, looked up at call time. There is no fallback.
That launch is forward only (``build.forward_only``). The kernel runs the
chain's products on the tensor cores at float32 accuracy through
error-compensated TF32 (csrc/mlp_tc.cuh: each operand split as hi + lo by
``split_tf32``, each product lo*hi + hi*lo + hi*hi); its weights are split
and laid out by one launch before it (``pack_tf32_chain_cuda``, whose
plain version is ``pack_tf32_chain``). ``sa_ball_mlp_max_3xtf32_plain`` is
the plain version with the chain in that arithmetic.

The bf16 form (a bf16 model's, TPU.COMPUTE_DTYPE bfloat16) follows the
TPU kernel's arithmetic (sa_fused.py:_kernel_t, :316-337): v bf16; each
centred offset formed in float32 and rounded to bf16 (ctd); the xyz term
three bf16 products bf16(w0x[k]) * ctd[k] summed (t0 + t1) + t2 in bf16,
each operation rounded; x = v[idx] + pos in bf16; then

    x0 = bf16(relu(x * mul0 + add0))   (float32, the product and sum each
                                        rounded)

and the chain on bf16 weights (the folded chain rounded), each layer
bf16(relu(x W + b)) with float32 sums, the max over the ball, bf16 out.
``sa_ball_mlp_max`` dispatches on v's dtype: a bf16 v takes
``sa_ball_mlp_max_bf16_cuda`` on the card (csrc/sa.cu's bf16 form, its
weights packed by ``pack_bf16_chain_cuda``, plain ``pack_bf16_chain``;
counted in ``launches_bf16``) and ``sa_ball_mlp_max_bf16_plain`` on the
CPU. Each form raises on the other's dtype; nothing is cast to reach a
kernel.

The train form ``sa_ball_mlp_max_train`` (counterpart of sa_fused.py:1073,
a ``jax.custom_vjp``) is a ``torch.autograd.Function``: the kernel as its
forward, and as its backward autograd of the plain version recomputed
(JAX's backward is ``jax.vjp`` of ``_sa_xla_oracle``, which recomputes
too). Its launch point is ``sa_ball_mlp_max_train_cuda``. The JAX package
takes its kernel in training only for bf16 models, because that kernel
rounds to bf16 inside; this kernel computes in float32, so the port takes
it for the float32 model. On a bf16 v (a bf16 model's BN-free scales, the
JAX package's own case) the forward is the bf16 kernel, counted in
``train_launches_bf16``, and the backward autograd of
``sa_ball_mlp_max_bf16_plain``, which rounds where ``_sa_xla_oracle``
rounds (sa_fused.py:1043-1069: the centred offsets and w0x's xyz columns
rounded to bf16, the xyz term (t0 + t1) + t2 in bf16, the affine and ReLU
in float32 rounded once, each layer's float32 sums rounded once, the max);
the output gradient arrives bf16, as JAX casts it to the oracle's dtype.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..points import ball_query, group_points
from . import build
from .conv3d import F32_SUM_ERR, bf16_step, split_tf32

# Launches of the CUDA kernel in this process, by the eval wrapper and by
# the train form's forward, and of its bf16 form; a caller may reset them
# to 0 around a run it wants to count.
launches = 0
train_launches = 0
launches_bf16 = 0
train_launches_bf16 = 0

BF16 = torch.bfloat16

MAX_LAYERS = 4
# the kernel's row tiles hold whole balls: S must divide 16, 32 or 64
MAX_S = 64
# the plain version works on batch chunks of at most this many grouped
# activations, so that the reference budget's 6400 clouds fit on the card
PLAIN_CHUNK_ELEMS = 1 << 27

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _lib() -> ctypes.CDLL:
    lib = build.load("sa")
    if lib.sa_cuda.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.sa_cuda, lib.sa_bf16_cuda):
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p, p, i]
        for fn in (lib.sa_pack_cuda, lib.sa_pack_bf16_cuda):
            fn.argtypes = [p, p, i, p, p, i]
        for fn in (lib.sa_packed_floats, lib.sa_packed_words_bf16):
            fn.argtypes = [p, i]
        for fn in (lib.sa_cuda, lib.sa_bf16_cuda, lib.sa_pack_cuda, lib.sa_pack_bf16_cuda,
                   lib.sa_packed_floats, lib.sa_packed_words_bf16):
            fn.restype = i
        lib.sa_error_string.argtypes = [i]
        lib.sa_error_string.restype = ctypes.c_char_p
    return lib


def mlp_chain(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """The folded chain: x = relu(x W + b) per layer."""
    for w, b in weights:
        x = torch.relu(x @ w + b)
    return x


def product_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the tensor-core kernel's arithmetic: both split by
    split_tf32, lo*hi + hi*lo + hi*hi (a product of two TF32 values is
    exact in float32)."""
    (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w)
    return xl @ wh + xh @ wl + xh @ wh


def mlp_chain_3xtf32(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """mlp_chain with each product in the kernel's 3xTF32 arithmetic."""
    for w, b in weights:
        x = torch.relu(product_3xtf32(x, w) + b)
    return x


def sa_ball_mlp_max_plain(xyz: torch.Tensor, centers: torch.Tensor, v: torch.Tensor,
                          w0x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                          weights: Weights, radius: float, s: int,
                          chain: Optional[Callable] = None) -> torch.Tensor:
    """xyz (B, N, 3), centers (B, M, 3), v (B, N, C0), w0x (3, C0), mul0 and
    add0 (C0,), weights [(W (Ci, Co), b (Co,))] -> (B, M, C_last). `chain`
    (x, weights) -> activations runs the layers after mlp0 (mlp_chain by
    default)."""
    b, m = centers.shape[:2]
    widest = max([v.shape[-1]] + [w.shape[1] for w, _ in weights])
    step = max(1, PLAIN_CHUNK_ELEMS // (m * s * widest))
    outs = []
    for lo in range(0, b, step):
        p, c, vv = xyz[lo:lo + step], centers[lo:lo + step], v[lo:lo + step]
        idx = ball_query(c, p, radius, s)
        gx = group_points(p, idx) - c[:, :, None, :]
        term = (gx[..., 0:1] * w0x[0] + gx[..., 1:2] * w0x[1]) + gx[..., 2:3] * w0x[2]
        x = torch.relu((group_points(vv, idx) + term) * mul0 + add0)
        outs.append((chain or mlp_chain)(x, weights).amax(dim=2))
    return torch.cat(outs, 0)


def mlp_chain_bf16(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """The folded chain in the bf16 form's arithmetic: x (bf16) times each W
    rounded to bf16, the exact products summed in float32, + b (float32),
    ReLU, rounded to bf16 (JAX's jnp.maximum(dot(x, W) + b, 0).astype(
    bfloat16), sa_fused.py:330, fp_fused.py:71, grouped_mlp.py:36)."""
    for w, b in weights:
        x = torch.relu(x.float() @ w.to(BF16).float() + b).to(BF16)
    return x


def bf16_chain_floor(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """How far a bf16 chain's last float32 sums, before their rounding, may
    lie from another correct run of the same chain on the same x (per
    output): each layer's K float32 sums in another order differ by at most
    K * F32_SUM_ERR * (m @ |W|), m bounding the layer's input magnitudes
    (|x|, then m @ |W| + |b|), W rounded to bf16; a hidden layer's outputs
    may then round to different sides, one bf16 step of their bound apart at
    most, and that difference d reaches the next layer's sums as d @ |W|.
    A `chain` for the bf16 twins: a bf16 kernel and its twin differ before
    their last rounding by at most this (conv3d.bf16_agreement's floor);
    through a max over a ball it is the largest row's."""
    m = x.float().abs()
    d = torch.zeros_like(m)
    for i, (w, b) in enumerate(weights):
        wa = w.to(BF16).float().abs()
        y = m @ wa
        e = d @ wa + w.shape[0] * F32_SUM_ERR * y
        if i + 1 == len(weights):
            return e
        m = y + b.abs()
        d = e + bf16_step(m)
    return torch.zeros_like(m)


def sa_ball_mlp_max_bf16_plain(xyz: torch.Tensor, centers: torch.Tensor, v: torch.Tensor,
                               w0x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                               weights: Weights, radius: float, s: int,
                               chain: Optional[Callable] = None) -> torch.Tensor:
    """The bf16 form's plain version: as sa_ball_mlp_max_plain with v (B, N,
    C0) bf16 and the TPU kernel's roundings (the module doc) -> (B, M,
    C_last) bf16. w0x, mul0, add0 and the weights float32. `chain` (x0,
    weights) -> activations runs the layers after mlp0 (mlp_chain_bf16 by
    default)."""
    b, m = centers.shape[:2]
    widest = max([v.shape[-1]] + [w.shape[1] for w, _ in weights])
    step = max(1, PLAIN_CHUNK_ELEMS // (m * s * widest))
    w0 = w0x.to(BF16)
    outs = []
    for lo in range(0, b, step):
        p, c, vv = xyz[lo:lo + step], centers[lo:lo + step], v[lo:lo + step]
        idx = ball_query(c, p, radius, s)
        ctd = (group_points(p, idx) - c[:, :, None, :]).to(BF16)
        pos = (ctd[..., 0:1] * w0[0] + ctd[..., 1:2] * w0[1]) + ctd[..., 2:3] * w0[2]
        x = group_points(vv, idx) + pos
        x = torch.relu(x.float() * mul0 + add0).to(BF16)
        outs.append((chain or mlp_chain_bf16)(x, weights).amax(dim=2))
    return torch.cat(outs, 0)


def sa_ball_mlp_max_3xtf32_plain(xyz, centers, v, w0x, mul0, add0, weights, radius,
                                 s) -> torch.Tensor:
    """sa_ball_mlp_max_plain with the chain in the kernel's 3xTF32
    arithmetic (mlp_chain_3xtf32)."""
    return sa_ball_mlp_max_plain(xyz, centers, v, w0x, mul0, add0, weights, radius, s,
                                 chain=mlp_chain_3xtf32)


def pack_tf32_chain(weights: Weights) -> torch.Tensor:
    """The chain's weights as csrc/sa.cu's kernel reads them: per layer W
    (Ci, Co), padded with zeros to (8 K8, 8 N8), K8 = ceil(Ci / 8), N8 =
    ceil(Co / 8), as (K8, N8, 32 lanes, 4): lane l of N-tile nt in k8 step
    kk holds [hi(k), hi(k + 4), lo(k), lo(k + 4)] of the weight from row
    8 kk + k, k = l % 4, to column 8 nt + l // 4 (mma.m16n8k8's B fragment),
    split by split_tf32; the layers flattened one after the other. The
    plain version of the kernel's own packing, pack_tf32_chain_cuda."""
    parts = []
    for w, _ in weights:
        ci, co = w.shape
        k8, n8 = -(-ci // 8), -(-co // 8)
        hi, lo = split_tf32(torch.nn.functional.pad(w, (0, 8 * n8 - co, 0, 8 * k8 - ci)))

        def fragments(t):
            # (kk, k >= 4, k % 4, nt, l // 4) -> (kk, nt, l, k >= 4)
            return t.reshape(k8, 2, 4, n8, 8).permute(0, 3, 4, 2, 1).reshape(k8, n8, 32, 2)
        parts.append(torch.cat((fragments(hi), fragments(lo)), dim=-1).reshape(-1))
    return torch.cat(parts)


def pack_bf16_chain(weights: Weights) -> torch.Tensor:
    """The chain's weights as csrc/sa.cu's bf16 form reads them, int32 words
    of two bf16: per layer W (Ci, Co) padded with zeros to (16 K16, 16
    ceil(Co / 16)), rounded to bf16 (nearest even), as (K16, N8, 32 lanes,
    2): word e of lane l of N-tile nt in k16 step kk holds the weights from
    rows 16 kk + 8 e + 2 (l % 4) (lower half) and the next one to column 8
    nt + l // 4 (mma.m16n8k16's B fragment); the layers flattened one after
    the other. The plain version of pack_bf16_chain_cuda."""
    parts = []
    for w, _ in weights:
        ci, co = w.shape
        k16, n16 = -(-ci // 16), -(-co // 16)
        wp = torch.nn.functional.pad(w, (0, 16 * n16 - co, 0, 16 * k16 - ci))
        # (kk, e, t, pair, nt, g) -> (kk, nt, g, t, e, pair)
        frag = wp.reshape(k16, 2, 4, 2, 2 * n16, 8).permute(0, 4, 5, 2, 1, 3)
        parts.append(frag.to(BF16).contiguous().view(torch.int32).reshape(-1))
    return torch.cat(parts)


def _chain_args(weights: Weights, c0: int):
    chans = [c0] + [w.shape[1] for w, _ in weights]
    nl = len(weights)
    wptr = (ctypes.c_void_p * max(nl, 1))(*[w.data_ptr() for w, _ in weights])
    return wptr, (ctypes.c_int * len(chans))(*chans), nl


def pack_tf32_chain_cuda(weights: Weights) -> torch.Tensor:
    """pack_tf32_chain(weights) in one launch of csrc/sa.cu's packing on the
    current stream (each W float32, contiguous, on one card; 1 to
    MAX_LAYERS layers)."""
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"need 1 to {MAX_LAYERS} layers, got {len(weights)}")
    dev = weights[0][0].device
    cin = weights[0][0].shape[0]
    for i, (w, _) in enumerate(weights):
        _check(f"weights[{i}]", w, (cin, w.shape[1]), dev)
        cin = w.shape[1]
    lib = _lib()
    wptr, carr, nl = _chain_args(weights, weights[0][0].shape[0])
    out = torch.empty(lib.sa_packed_floats(carr, nl), device=dev)
    err = lib.sa_pack_cuda(wptr, carr, nl, out.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"sa_pack_cuda launch failed: {lib.sa_error_string(err).decode()}")
    return out


def pack_bf16_chain_cuda(weights: Weights) -> torch.Tensor:
    """pack_bf16_chain(weights) in one launch of csrc/sa.cu's bf16 packing on
    the current stream (each W float32, contiguous, on one card; 1 to
    MAX_LAYERS layers)."""
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"need 1 to {MAX_LAYERS} layers, got {len(weights)}")
    dev = weights[0][0].device
    cin = weights[0][0].shape[0]
    for i, (w, _) in enumerate(weights):
        _check(f"weights[{i}]", w, (cin, w.shape[1]), dev)
        cin = w.shape[1]
    lib = _lib()
    wptr, carr, nl = _chain_args(weights, weights[0][0].shape[0])
    out = torch.empty(lib.sa_packed_words_bf16(carr, nl), dtype=torch.int32, device=dev)
    err = lib.sa_pack_bf16_cuda(wptr, carr, nl, out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"sa_pack_bf16_cuda launch failed: "
                           f"{lib.sa_error_string(err).decode()}")
    return out


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if t.dtype != dtype or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sa_ball_mlp_max_cuda(xyz: torch.Tensor, centers: torch.Tensor, v: torch.Tensor,
                         w0x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                         weights: Weights, radius: float, s: int) -> torch.Tensor:
    """Launch csrc/sa.cu on the current stream; same contract as
    sa_ball_mlp_max_plain. Every tensor float32, contiguous, on one card."""
    global launches
    build.forward_only("sa_ball_mlp_max_cuda", xyz, centers, v, w0x, mul0, add0,
                       *(t for pair in weights for t in pair))
    out = _sa_launch(xyz, centers, v, w0x, mul0, add0, weights, radius, s)
    launches += 1
    return out


def _sa_launch(xyz, centers, v, w0x, mul0, add0, weights, radius, s, bf16: bool = False):
    """One launch of the SA kernel (its bf16 form: v and the output bf16),
    not counted."""
    if not xyz.is_cuda:
        raise ValueError(f"xyz must be on a CUDA device, got {xyz.device}")
    dev = xyz.device
    b, n = xyz.shape[:2]
    m = centers.shape[1]
    c0 = v.shape[-1]
    _check("xyz", xyz, (b, n, 3), dev)
    _check("centers", centers, (b, m, 3), dev)
    _check("v", v, (b, n, c0), dev, BF16 if bf16 else torch.float32)
    _check("w0x", w0x, (3, c0), dev)
    _check("mul0", mul0, (c0,), dev)
    _check("add0", add0, (c0,), dev)
    chans = [c0]
    for i, (w, bias) in enumerate(weights):
        _check(f"weights[{i}]", w, (chans[-1], w.shape[1]), dev)
        _check(f"bias[{i}]", bias, (w.shape[1],), dev)
        chans.append(w.shape[1])
    if len(weights) > MAX_LAYERS or not 1 <= s <= MAX_S or 64 % s or not 1 <= b <= 65535:
        raise ValueError(f"need at most {MAX_LAYERS} layers, S dividing 64 and B <= 65535, "
                         f"got {len(weights)} layers, S={s}, B={b}")
    lib = _lib()
    pack = pack_bf16_chain_cuda if bf16 else pack_tf32_chain_cuda
    wpk = pack(weights) if weights else None
    out = torch.empty((b, m, chans[-1]), dtype=v.dtype, device=dev)
    _, carr, nl = _chain_args(weights, c0)
    bptr = (ctypes.c_void_p * max(nl, 1))(*[bias.data_ptr() for _, bias in weights])
    fn, name = (lib.sa_bf16_cuda, "sa_bf16_cuda") if bf16 else (lib.sa_cuda, "sa_cuda")
    err = fn(xyz.data_ptr(), centers.data_ptr(), v.data_ptr(), w0x.data_ptr(), mul0.data_ptr(),
             add0.data_ptr(), None if wpk is None else wpk.data_ptr(), bptr, carr, nl, b, n, m, s,
             float(radius) * float(radius), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.sa_error_string(err).decode()}")
    return out


def sa_ball_mlp_max_bf16_cuda(xyz: torch.Tensor, centers: torch.Tensor, v: torch.Tensor,
                              w0x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                              weights: Weights, radius: float, s: int) -> torch.Tensor:
    """Launch csrc/sa.cu's bf16 form on the current stream; same contract as
    sa_ball_mlp_max_bf16_plain. v bf16, every other tensor float32, all
    contiguous, on one card."""
    global launches_bf16
    build.forward_only("sa_ball_mlp_max_bf16_cuda", xyz, centers, v, w0x, mul0, add0,
                       *(t for pair in weights for t in pair))
    out = _sa_launch(xyz, centers, v, w0x, mul0, add0, weights, radius, s, bf16=True)
    launches_bf16 += 1
    return out


def sa_ball_mlp_max(xyz: torch.Tensor, centers: torch.Tensor, v: torch.Tensor,
                    w0x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                    weights: Weights, radius: float, s: int) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; the bf16 form
    for a bf16 v."""
    if v.dtype == BF16:
        fn = sa_ball_mlp_max_bf16_cuda if xyz.is_cuda else sa_ball_mlp_max_bf16_plain
    else:
        fn = sa_ball_mlp_max_cuda if xyz.is_cuda else sa_ball_mlp_max_plain
    return fn(xyz, centers, v, w0x, mul0, add0, weights, radius, s)


def sa_ball_mlp_max_train_cuda(xyz, centers, v, w0x, mul0, add0, weights, radius, s):
    """The train form's forward: the SA kernel, its bf16 form for a bf16 v."""
    global train_launches, train_launches_bf16
    bf16 = v.dtype == BF16
    out = _sa_launch(xyz, centers, v, w0x, mul0, add0, weights, radius, s, bf16=bf16)
    if bf16:
        train_launches_bf16 += 1
    else:
        train_launches += 1
    return out


class _SATrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, s, xyz, centers, v, w0x, mul0, add0, *flat):
        ctx.radius, ctx.s = radius, s
        ctx.save_for_backward(xyz, centers, v, w0x, mul0, add0, *flat)
        weights = list(zip(flat[0::2], flat[1::2]))
        return sa_ball_mlp_max_train_cuda(xyz, centers, v, w0x, mul0, add0, weights, radius, s)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            xyz, centers, v, w0x, mul0, add0, *flat = leaves
            plain = sa_ball_mlp_max_bf16_plain if v.dtype == BF16 else sa_ball_mlp_max_plain
            out = plain(xyz, centers, v, w0x, mul0, add0, list(zip(flat[0::2], flat[1::2])),
                        ctx.radius, ctx.s)
            wanted = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(out, wanted, dout, allow_unused=True))
        return (None, None, *(next(got) if n else None for n in need))


def sa_ball_mlp_max_train(xyz: torch.Tensor, centers: torch.Tensor, v: torch.Tensor,
                          w0x: torch.Tensor, mul0: torch.Tensor, add0: torch.Tensor,
                          weights: Weights, radius: float, s: int) -> torch.Tensor:
    """sa_ball_mlp_max, differentiable in every tensor argument (v, w0x,
    mul0, add0 and each (W, b) for the train step; xyz and centers through
    the neighbour offsets). CUDA tensors take the kernel forward and the
    plain version's autograd backward, CPU tensors the plain version; a
    bf16 v the bf16 forms of both."""
    if xyz.is_cuda:
        flat = [t for pair in weights for t in pair]
        return _SATrain.apply(float(radius), int(s), xyz, centers, v, w0x, mul0, add0, *flat)
    plain = sa_ball_mlp_max_bf16_plain if v.dtype == BF16 else sa_ball_mlp_max_plain
    return plain(xyz, centers, v, w0x, mul0, add0, weights, radius, s)
