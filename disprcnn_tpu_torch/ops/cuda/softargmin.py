"""PSMNet's eval regression head: align-corners trilinear upsample of the
cost logits, softmax over disparity, expected disparity. The CUDA kernel's
wrapper and its plain PyTorch version (counterparts of
disprcnn_tpu/ops/pallas/softargmin.py:fused_softargmin and of the plain
``regress`` in disprcnn_tpu/models/psmnet/psmnet.py:1000-1020).

``softargmin`` dispatches: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel (csrc/softargmin.cu), whose one launch point is
``softargmin_cuda``, looked up at call time. There is no fallback.
``disparity_segments`` builds the D interpolation's taps by segment, as the
kernel takes them; ``softargmin_segments_plain`` is the kernel's order of
operations on the CPU.

bf16 logits (the JAX package's bf16 model, whose classifier's cost is
bf16) take the kernel's bf16 form, ``softargmin_bf16_cuda``: each logit
converted to float32 as it is read (exact), then the float32 walk, float32
out, as JAX's bf16 model casts the cost to float32 before
fused_softargmin (psmnet.py:1008-1011). Its twin is the float32 plain
version of the logits cast up (``softargmin_bf16_plain``); its launches are
counted in ``launches_bf16``. A bf16 tensor given to ``softargmin_cuda``
raises, and a float32 one to ``softargmin_bf16_cuda``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

# Launches of the CUDA kernel (its float32 and bf16 forms) in this process;
# a caller may reset them to 0 around a run it wants to count.
launches = 0
launches_bf16 = 0

# the kernel keeps one pixel's D4 bilinear values in a thread, and the D
# taps in its argument (csrc/softargmin.cu kMaxD4, kMaxD)
MAX_D4 = 64
MAX_D = 512
LOG2E = 1.4426950408889634


def _lib() -> ctypes.CDLL:
    lib = build.load("softargmin")
    if lib.softargmin_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.softargmin_cuda, lib.softargmin_bf16_cuda):
            fn.argtypes = [p, i, i, i, i, i, i, i, i, p, p, p, p, p, i]
            fn.restype = i
        lib.softargmin_error_string.argtypes = [i]
        lib.softargmin_error_string.restype = ctypes.c_char_p
    return lib


def _positions(n_in: int, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i0, frac) of interp_matrix_align_corners's rows, on the CPU: the
    float32 positions o * (n_in - 1) / max(n_out - 1, 1) with i0 clamped to
    [0, n_in - 2]; n_in >= 2."""
    pos = torch.arange(n_out, dtype=torch.float32) * (n_in - 1) / max(n_out - 1, 1)
    i0 = torch.floor(pos).long().clamp(0, n_in - 2)
    return i0, pos - i0


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
        i0, frac = _positions(n_in, n_out)
        rows = torch.arange(n_out)
        m = torch.zeros((n_out, n_in))
        m[rows, i0] = 1.0 - frac
        m[rows, i0 + 1] = frac
        return m.to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=64)
def disparity_segments(d4: int, d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The D interpolation (D4 -> D) as the kernel walks it, on the CPU:
    (fk (D,) float32, first (S,) int16, count (S,) int16), S = max(D4 - 1,
    1). Segment s holds disparities first[s] .. first[s] + count[s] - 1
    (count 0 where D < D4 skips it), each at position s + fk[k]: weight 1 -
    fk[k] on logit s and fk[k] on logit s + 1, exactly the nonzeros of
    interp_matrix_align_corners(d4, d) (D4 = 1: one segment, fk = 0, weight
    1 on logit 0). Shared: callers must not modify it."""
    nseg = max(d4 - 1, 1)
    if d4 == 1:
        fk, i0 = torch.zeros(d), torch.zeros(d, dtype=torch.long)
    else:
        i0, fk = _positions(d4, d)
    count = torch.bincount(i0, minlength=nseg)
    first = torch.cumsum(count, 0) - count
    return fk, first.to(torch.int16), count.to(torch.int16)


def softargmin_segments_plain(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
                              maxdisp: int) -> torch.Tensor:
    """softargmin_plain in the kernel's order: per pixel the H and W taps
    first, as four weights ((1 - fy)(1 - fx), ...) on the four logits of each
    slice (v, (B, D4, H, W)), then per segment z = v[s] + fk (v[s + 1] -
    v[s]); the max over D from each segment's two ends; exp(z - m) as 2^((z
    - m) log2 e), with log2 e folded into the segment's two constants; per
    segment sums of exp and exp * j (j the disparity's place in it), then
    into the totals with the segment's first place; mindisp is added to
    the expected place last."""
    b, d4, h4, w4 = logits.shape
    h, w = out_hw
    fk, first, count = disparity_segments(d4, maxdisp - mindisp)
    fk = fk.to(logits.device)

    def taps(n_in, n_out):
        if n_in == 1:
            zero = torch.zeros(n_out, dtype=torch.long)
            return zero, zero, torch.zeros(n_out)
        i0, f = _positions(n_in, n_out)
        return i0, i0 + 1, f

    y0, y1, fy = (t.to(logits.device) for t in taps(h4, h))
    x0, x1, fx = (t.to(logits.device) for t in taps(w4, w))
    fy, fx = fy[:, None], fx[None, :]
    r0, r1 = logits[:, :, y0], logits[:, :, y1]  # (B, D4, H, w4)
    v = ((1 - fy) * (1 - fx) * r0[..., x0] + (1 - fy) * fx * r0[..., x1]
         + fy * (1 - fx) * r1[..., x0]) + fy * fx * r1[..., x1]  # (B, D4, H, W)
    segments = [(s, int(first[s]), int(count[s])) for s in range(len(count)) if count[s] > 0]

    def ends(s):
        a = v[:, s]
        return a, (v[:, s + 1] if s + 1 < d4 else a) - a

    m = torch.full((b, h, w), -torch.inf, dtype=logits.dtype, device=logits.device)
    for s, k0, cnt in segments:
        a, g = ends(s)
        m = torch.maximum(m, torch.maximum(a + fk[k0] * g, a + fk[k0 + cnt - 1] * g))
    total = torch.zeros_like(m)
    dtotal = torch.zeros_like(m)
    for s, k0, cnt in segments:
        a, g = ends(s)
        gl, al = g * LOG2E, (a - m) * LOG2E
        ss = torch.zeros_like(m)
        sj = torch.zeros_like(m)
        for j in range(cnt):
            e = torch.exp2(fk[k0 + j] * gl + al)
            ss = ss + e
            sj = sj + e * j
        total = total + ss
        dtotal = dtotal + k0 * ss + sj
    return mindisp + dtotal / total


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


def softargmin_bf16_plain(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
                          maxdisp: int) -> torch.Tensor:
    """The bf16 form's twin: softargmin_plain of the bf16 logits cast up to
    float32 (exact); float32 out."""
    return softargmin_plain(logits.float(), out_hw, mindisp, maxdisp)


class _SoftmaxJAX(torch.autograd.Function):
    """jax.nn.softmax over dim 1 at the input's dtype, each operation rounded
    as in its source (the max, x - max, exp, the sum accumulated in float32
    and rounded, the division), and its gradient as JAX's custom JVP
    transposes it: g = y * ct, then g - y * sum(g) (each product, the sum and
    the difference rounded)."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(x - x.amax(dim=1, keepdim=True))
        y = e / e.sum(dim=1, keepdim=True)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, ct):
        (y,) = ctx.saved_tensors
        g = y * ct
        return g - y * g.sum(dim=1, keepdim=True)


def softargmin_train_bf16(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
                          maxdisp: int) -> torch.Tensor:
    """The JAX package's train-mode regression of a bf16 model (its XLA
    ``regress``, psmnet.py:1001-1011): softargmin_plain's contractions on
    the bf16 logits with the interpolation matrices in bf16, each rounded,
    jax.nn.softmax's bf16 arithmetic (``_SoftmaxJAX``) and the expectation
    with bf16 disparities -> (B, H, W) bf16, differentiable."""
    _, d4, h4, w4 = logits.shape
    h, w = out_hw
    dev, dt = logits.device, logits.dtype
    c = torch.einsum("bdhw,ed->behw", logits,
                     interp_matrix_align_corners(d4, maxdisp - mindisp, dev, dt))
    c = torch.einsum("bdhw,eh->bdew", c, interp_matrix_align_corners(h4, h, dev, dt))
    c = torch.einsum("bdhw,ew->bdhe", c, interp_matrix_align_corners(w4, w, dev, dt))
    p = _SoftmaxJAX.apply(c)
    disp = torch.arange(mindisp, maxdisp, dtype=dt, device=dev)
    return torch.einsum("bdhw,d->bhw", p, disp)


def softargmin_cuda(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
                    maxdisp: int) -> torch.Tensor:
    """Launch csrc/softargmin.cu on the current stream; same contract as
    softargmin_plain."""
    global launches
    out = _launch(logits, out_hw, mindisp, maxdisp, torch.float32, "softargmin_cuda")
    launches += 1
    return out


def softargmin_bf16_cuda(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
                         maxdisp: int) -> torch.Tensor:
    """Launch csrc/softargmin.cu's bf16 form on the current stream: bf16
    logits, float32 out; same contract as softargmin_bf16_plain."""
    global launches_bf16
    out = _launch(logits, out_hw, mindisp, maxdisp, torch.bfloat16, "softargmin_bf16_cuda")
    launches_bf16 += 1
    return out


def _launch(logits, out_hw, mindisp, maxdisp, dtype, name):
    build.forward_only(name, logits)
    if logits.dim() != 4 or logits.dtype != dtype or not logits.is_cuda:
        raise ValueError(f"logits must be (B, D4, h4, w4) {str(dtype).split('.')[-1]} on CUDA, "
                         f"got {tuple(logits.shape)} {logits.dtype} on {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    b, d4, h4, w4 = logits.shape
    h, w = out_hw
    if d4 > MAX_D4 or not 0 < maxdisp - mindisp <= MAX_D:
        raise ValueError(f"need D4 <= {MAX_D4} and 0 < maxdisp - mindisp <= {MAX_D}, got "
                         f"D4={d4} [{mindisp}, {maxdisp})")
    fk, first, count = disparity_segments(d4, maxdisp - mindisp)
    lib = _lib()
    out = torch.empty((b, h, w), device=logits.device)
    err = getattr(lib, name)(
        logits.data_ptr(), b, d4, h4, w4, h, w, mindisp, maxdisp, fk.data_ptr(),
        first.data_ptr(), count.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(logits.device).cuda_stream, logits.device.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.softargmin_error_string(err).decode()}")
    return out


def softargmin(logits: torch.Tensor, out_hw: Tuple[int, int], mindisp: int,
               maxdisp: int) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; bf16 logits
    take the bf16 form (kernel or twin)."""
    if logits.dtype == torch.bfloat16:
        if logits.is_cuda:
            return softargmin_bf16_cuda(logits, out_hw, mindisp, maxdisp)
        return softargmin_bf16_plain(logits, out_hw, mindisp, maxdisp)
    if logits.is_cuda:
        return softargmin_cuda(logits, out_hw, mindisp, maxdisp)
    return softargmin_plain(logits, out_hw, mindisp, maxdisp)
