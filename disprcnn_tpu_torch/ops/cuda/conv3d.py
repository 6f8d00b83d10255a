"""The PSMNet convolutions with a fused epilogue: the CUDA kernels'
wrappers and their plain PyTorch versions (counterparts of
disprcnn_tpu/ops/pallas/packed_conv.py: ``packed_conv_bn``, its dg=1 "cl1"
use, ``cost_volume_conv_bn``, ``packed_conv_bn_s2``, ``packed_deconv_bn``
and ``wpacked_conv_bn``).

- ``conv3d_bn``: 3x3x3 conv, stride 1 or 2, padding 1;
- ``cost_volume_conv_bn``: the stride-1 conv over the PSMNet concat cost
  volume, built on the fly;
- ``deconv3d_bn``: the 3x3x3 stride-2 transposed conv of torch
  ``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)``;
- ``conv2d_bn``: 3x3 stride-1 pad-1 2D conv.

Layout is the canonical NCDHW (NCHW in 2D). The epilogue is ``y * mul +
add`` (the folded eval BatchNorm, per output channel), then ``+ residual``,
then ReLU, in that order. ``mul``/``add`` of None is the identity (the
classifier's bias-free 32 -> 1 conv).

Each function dispatches: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel. There is no fallback: a kernel that fails to
build or launch raises. ``conv3d_bn`` at Co 32 and 64 (stride 1 and 2),
``deconv3d_bn`` and ``conv2d_bn`` are csrc/conv3d_tc.cu, an implicit GEMM
on the tensor cores at float32 accuracy through error-compensated TF32
("3xTF32": each operand split as hi + lo by ``split_tf32``, each product
lo*hi + hi*lo + hi*hi; the weights are split and laid out by
``pack_tf32_weight``; ``conv3d_bn_3xtf32_plain``,
``deconv3d_bn_3xtf32_plain`` and ``conv2d_bn_3xtf32_plain`` are the same
arithmetic in ``F.conv3d`` or ``F.conv2d`` calls); the 2D conv is the 3D
body at depth 1, the transposed conv the same GEMM split by output parity
(``deconv3d_bn_parity_plain``). ``cost_volume_conv_bn`` is
csrc/cost_volume_tc.cu: the tap planes of each view on the tensor cores in
the same arithmetic, then their masked, shifted sums
(``cost_volume_conv_bn_planes_plain``; ``cost_volume_conv_bn_3xtf32_plain``
in the kernel's arithmetic; weights laid out by
``pack_tf32_cost_volume_weight``). The classifier's Co = 1 conv is
csrc/conv3d.cu, a depth-marching stencil on the CUDA cores that sums each
output's products in (kd, c, kh, kw) order (``conv3d_cl1_march_plain``).
The launch points are
``conv3d_bn_cuda``, ``cost_volume_conv_bn_cuda``, ``deconv3d_bn_cuda`` and
``conv2d_bn_cuda``, looked up at call time, so a caller can route them
elsewhere. These launches are forward only (``build.forward_only``).

The bf16 forms (the JAX package's bf16 model, TPU.COMPUTE_DTYPE
bfloat16): ``conv3d_bn``, ``conv2d_bn``, ``deconv3d_bn`` and
``cost_volume_conv_bn`` dispatch on the input's dtype. A bf16 input (and
residual) on the card launches the kernel's bf16 form: the weights rounded
to bf16 by their packing, exact products into float32 sums, the BN
affine, residual and ReLU in float32, and one rounding to bf16 (nearest
even) at the store, as the JAX package's Pallas kernels do with bf16
operands. ``cost_volume_conv_bn`` runs one bf16 ``mma.sync`` a K step
on csrc/cost_volume_tc.cu's body (``pack_bf16_cost_volume_weight``: k16
fragments of bf16 pairs); ``conv3d_bn`` at Co 32 and 64 (stride 1 and
2), ``conv2d_bn`` and ``deconv3d_bn`` are csrc/conv_bf16_wgmma.cu, one
kernel body in three forms (stride 1, transposed, stride 2): warpgroup
products (``wgmma``) over a halo laid channels-innermost in shared memory
(at stride 2 as its four parity planes, ``conv3d_s2_parity_plain``; at
stride 1 and Co 64, two whole output slices a tile where that takes
fewer rounds, ``conv3d_slice_pair_plain``), each tap an address offset, with TMA copies in and out (``pack_wgmma_weight``:
each tap's 16 x Co block in wgmma's K-major core matrices); they take any
Ci and raise on a Co other than 32 or 64 and on an input row wider than
their tiles take (``conv_bf16_wgmma_max_width``). The classifier's Co = 1
form (csrc/conv3d.cu) rounds its
conv to bf16 before the residual (the previous classifier's cost) joins
and rounds the sum again, as JAX's separate bf16 add does. On the CPU a
bf16 input takes the bf16 twin (``*_bf16_plain``): the float32 plain
version of the same bf16 values cast up (a product of two bf16 values is
exact in float32), rounded to bf16 where the kernel stores. The launch
points are
``*_bf16_cuda``, counted in ``launches_bf16``. Each form checks its
dtypes: a bf16 tensor given to a float32 launch point raises, and a
float32 one to a bf16 launch point; nothing is cast to reach a kernel.

The train form of the stride-1 conv, ``conv3d_train`` (counterpart of
``packed_conv_train``, packed_conv.py:689, a ``jax.custom_vjp``), is a
``torch.autograd.Function``: its forward is the raw conv (identity
epilogue, no residual, no ReLU: the train path's batch-stat BN stays
outside) and its input gradient is the same kernel again, run on the
output gradient with the flipped, channel-transposed weights; the weight
gradient is PyTorch's (the JAX package takes both from XLA). Its launch
points are ``conv3d_train_cuda`` and ``conv3d_train_dx_cuda``. On a bf16 x
(a bf16 model's train step; packed_conv_train on a bf16 packed volume and
a bf16 kernel) both launch the bf16 form: the forward rounds the conv to
bf16 once, the output gradient arrives bf16 (JAX's ``_pct_bwd`` casts the
cotangent to the conv's dtype) and the input gradient is the bf16 conv of
it with the flipped weights rounded to bf16 (``pack_wgmma_weight``'s
"flip" form), rounded once; the weight
gradient is PyTorch's on the bf16 tensors (XLA's transpose in JAX),
rounded to bf16 and widened to the float32 parameter. Its plain versions
are ``conv3d_train_bf16_plain`` (differentiable) and
``conv3d_train_dx_bf16_plain``; the launches count in
``launches_bf16["conv3d_train"]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..cost_volume import build_cost_volume
from . import build

# Launches of each kernel in this process; a caller may reset them to 0
# around a run it wants to count. "conv3d_cl1" is the Co = 1 instantiation
# of the stride-1 conv, "conv3d_s2" its stride-2 form.
# "conv3d_train" counts the train form's forward and input-gradient launches.
launches = {"cost_volume_conv": 0, "conv3d": 0, "conv3d_cl1": 0, "conv3d_s2": 0,
            "deconv3d": 0, "conv2d": 0, "conv3d_train": 0}
# Launches of the bf16 forms, by the same names.
launches_bf16 = {"cost_volume_conv": 0, "conv3d": 0, "conv3d_cl1": 0, "conv3d_s2": 0,
                 "deconv3d": 0, "conv2d": 0, "conv3d_train": 0}
BF16 = torch.bfloat16

# output channel counts the kernels are instantiated for; Co = 1 only for
# the stride-1 3D conv
CHANNELS = (32, 64)


def _lib() -> ctypes.CDLL:
    lib = build.load("conv3d")
    if lib.conv3d_bn_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3d_bn_cuda.argtypes = [p, i, i, i, i, i, p, p, p, p, i, p, p, i]
        lib.conv3d_bn_cuda.restype = i
        lib.conv3d_bn_bf16_cuda.argtypes = lib.conv3d_bn_cuda.argtypes
        lib.conv3d_bn_bf16_cuda.restype = i
        lib.conv3d_error_string.argtypes = [i]
        lib.conv3d_error_string.restype = ctypes.c_char_p
    return lib


def _tc_lib() -> ctypes.CDLL:
    lib = build.load("conv3d_tc")
    if lib.conv3d_tc_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3d_tc_cuda.argtypes = [p, i, i, i, i, i, i, p, i, p, p, p, i, p, p, i]
        lib.conv2d_tc_cuda.argtypes = [p, i, i, i, i, p, i, p, p, p, i, p, p, i]
        lib.deconv3d_tc_cuda.argtypes = [p, i, i, i, i, i, p, i, p, p, p, i, p, p, i]
        lib.conv3d_tc_pack_cuda.argtypes = [p, i, i, i, i, p, p, i]
        for fn in (lib.conv3d_tc_cuda, lib.conv2d_tc_cuda, lib.deconv3d_tc_cuda,
                   lib.conv3d_tc_pack_cuda):
            fn.restype = i
        lib.conv3d_tc_error_string.argtypes = [i]
        lib.conv3d_tc_error_string.restype = ctypes.c_char_p
    return lib


def _wg_lib() -> ctypes.CDLL:
    lib = build.load("conv_bf16_wgmma")
    if lib.conv2d_bf16_wgmma_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv2d_bf16_wgmma_cuda.argtypes = [p, i, i, i, i, p, i, p, p, p, i, p, p, i]
        lib.conv3d_bf16_wgmma_cuda.argtypes = [p, i, i, i, i, i, i, p, i, p, p, p, i, p, p, i]
        lib.deconv3d_bf16_wgmma_cuda.argtypes = [p, i, i, i, i, i, p, i, p, p, p, i, p, p, i]
        lib.conv_bf16_wgmma_pack_cuda.argtypes = [p, i, i, i, p, p, i]
        lib.conv_bf16_wgmma_max_width.argtypes = [i, i]
        for fn in (lib.conv2d_bf16_wgmma_cuda, lib.conv3d_bf16_wgmma_cuda,
                   lib.deconv3d_bf16_wgmma_cuda, lib.conv_bf16_wgmma_pack_cuda,
                   lib.conv_bf16_wgmma_max_width):
            fn.restype = i
        lib.conv_bf16_wgmma_error_string.argtypes = [i]
        lib.conv_bf16_wgmma_error_string.restype = ctypes.c_char_p
    return lib


def _cv_lib() -> ctypes.CDLL:
    lib = build.load("cost_volume_tc")
    if lib.cost_volume_tc_cuda.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cost_volume_tc_cuda.argtypes = [p, p, i, i, i, i, i, i, p, i, p, p, i, p, p, p, i]
        lib.cost_volume_tc_pack_cuda.argtypes = [p, i, i, p, p, i]
        lib.cost_volume_tc_bf16_cuda.argtypes = lib.cost_volume_tc_cuda.argtypes
        lib.cost_volume_tc_pack_bf16_cuda.argtypes = lib.cost_volume_tc_pack_cuda.argtypes
        for fn in (lib.cost_volume_tc_cuda, lib.cost_volume_tc_pack_cuda,
                   lib.cost_volume_tc_bf16_cuda, lib.cost_volume_tc_pack_bf16_cuda):
            fn.restype = i
        lib.cost_volume_tc_error_string.argtypes = [i]
        lib.cost_volume_tc_error_string.restype = ctypes.c_char_p
    return lib


def split_tf32(t: torch.Tensor):
    """float32 t -> (hi, lo), float32 tensors with t ~= hi + lo: hi is t
    rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
    lo is t - hi rounded the same way; |t - (hi + lo)| <= 2^-22 |t| for
    finite t. Integer bit operations: (bits + 0x1000) & ~0x1fff, which is
    cvt.rna.tf32.f32 for finite values."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(t)
    return hi, rna(t - hi)


def conv3d_bn_3xtf32_plain(x: torch.Tensor, weight: torch.Tensor,
                           mul: Optional[torch.Tensor] = None,
                           add: Optional[torch.Tensor] = None,
                           residual: Optional[torch.Tensor] = None, relu: bool = False,
                           stride: int = 1) -> torch.Tensor:
    """conv3d_bn_plain in the tensor-core kernel's arithmetic: the input
    and the weight split by split_tf32, the conv as lo*hi + hi*lo + hi*hi
    (three F.conv3d calls; a product of two TF32 values is exact in
    float32), then the epilogue."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(weight)
    y = (F.conv3d(xl, wh, stride=stride, padding=1) + F.conv3d(xh, wl, stride=stride, padding=1)
         + F.conv3d(xh, wh, stride=stride, padding=1))
    return _epilogue(y, mul, add, residual, relu)


def conv2d_bn_3xtf32_plain(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                           add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                           relu: bool = False) -> torch.Tensor:
    """conv2d_bn_plain in the tensor-core kernel's arithmetic, as
    conv3d_bn_3xtf32_plain (three F.conv2d calls)."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(weight)
    y = F.conv2d(xl, wh, padding=1) + F.conv2d(xh, wl, padding=1) + F.conv2d(xh, wh, padding=1)
    return _epilogue(y, mul, add, residual, relu)


def pack_tf32_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) -> csrc/conv3d_tc.cu's staged weights:
    (ceil(Ci / 8), 3 kd, 9 taps (kh, kw), Co / 8, 32 lanes, 4), Ci padded
    with zeros to a multiple of 8; a 2D weight (Co, Ci, 3, 3) -> the same
    without the kd dim (its one depth tap). Lane l of N-tile j in chunk cc
    holds [hi(k), hi(k + 4), lo(k), lo(k + 4)] of the weight from input
    channel 8 cc + k, k = l % 4, to output channel 8 j + l // 4: the B
    fragment of mma.m16n8k8 (b0 at row k, b1 at row k + 4, column l // 4),
    split by split_tf32. The plain version of the kernel's own packing,
    pack_tf32_weight_cuda."""
    w5 = weight[:, :, None] if weight.dim() == 4 else weight
    co, ci, kd = w5.shape[:3]
    ci8 = -(-ci // 8)
    hi, lo = split_tf32(F.pad(w5, (0, 0, 0, 0, 0, 0, 0, 8 * ci8 - ci)))

    def fragments(t):
        # (j, l // 4, cc, k >= 4, k % 4, kd, tap) -> (cc, kd, tap, j, l, k >= 4)
        t = t.reshape(co // 8, 8, ci8, 2, 4, kd, 9).permute(2, 5, 6, 0, 1, 4, 3)
        return t.reshape(ci8, kd, 9, co // 8, 32, 2)
    packed = torch.cat((fragments(hi), fragments(lo)), dim=-1)
    return (packed[:, 0] if weight.dim() == 4 else packed).contiguous()


# the weight forms of csrc/conv3d_tc.cu's packing (its PackForm)
_PACK_CONV, _PACK_FLIP, _PACK_DECONV = 0, 1, 2


def pack_tf32_weight_cuda(weight: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """pack_tf32_weight(weight), or with `flip` (3D only)
    pack_tf32_weight(flip_transpose(weight)), in one launch of
    csrc/conv3d_tc.cu's packing on the current stream (weight float32,
    contiguous, on the card)."""
    return _pack_conv(weight, flip)


def _pack_conv(weight, flip):
    co, ci = weight.shape[:2]
    if flip:
        co, ci = ci, co
    if weight.dim() not in (4, 5) or (flip and weight.dim() != 5):
        raise ValueError(f"need a (Co, Ci, 3, 3) or (Co, Ci, 3, 3, 3) weight (3D to flip), "
                         f"got {tuple(weight.shape)}")
    wkd = 3 if weight.dim() == 5 else 1
    _check_float32_cuda("weight", weight,
                        (ci, co, 3, 3, 3) if flip else (co, ci) + (3,) * (weight.dim() - 2),
                        weight.device)
    out = _pack_launch(weight, co, ci, wkd, _PACK_FLIP if flip else _PACK_CONV)
    return out[:, 0] if wkd == 1 else out


def pack_tf32_deconv_weight_cuda(weight: torch.Tensor) -> torch.Tensor:
    """pack_tf32_deconv_weight(weight) of the ConvTranspose3d weight (Ci, Co,
    3, 3, 3), in one launch of csrc/conv3d_tc.cu's packing on the current
    stream (weight float32, contiguous, on the card)."""
    return _pack_deconv(weight)


def _pack_deconv(weight):
    if weight.dim() != 5:
        raise ValueError(f"need a (Ci, Co, 3, 3, 3) weight, got {tuple(weight.shape)}")
    ci, co = weight.shape[:2]
    _check_float32_cuda("weight", weight, (ci, co, 3, 3, 3), weight.device)
    return _pack_launch(weight, co, ci, 3, _PACK_DECONV)


def _pack_launch(weight, co, ci, wkd, form):
    """One launch of csrc/conv3d_tc.cu's packing: (ceil(Ci / 8), wkd, 9,
    Co / 8, 32, 4) float32."""
    lib = _tc_lib()
    out = torch.empty((-(-ci // 8), wkd, 9, co // 8, 32, 4), device=weight.device)
    err = lib.conv3d_tc_pack_cuda(weight.data_ptr(), co, ci, wkd, form, out.data_ptr(),
                                  _stream(weight), weight.device.index)
    _raise_on(lib.conv3d_tc_error_string, err, "conv3d_tc_pack_cuda")
    return out


def pack_tf32_cost_volume_weight_cuda(weight: torch.Tensor) -> torch.Tensor:
    """pack_tf32_cost_volume_weight(weight) of the (Co, 2C, 3, 3, 3) weight,
    in one launch of csrc/cost_volume_tc.cu's packing on the current stream
    (weight float32, contiguous, on the card)."""
    return _pack_cost_volume(weight, torch.float32)


def pack_bf16_cost_volume_weight_cuda(weight: torch.Tensor) -> torch.Tensor:
    """pack_bf16_cost_volume_weight(weight) of the (Co, 2C, 3, 3, 3) weight,
    in one launch of csrc/cost_volume_tc.cu's bf16 packing."""
    return _pack_cost_volume(weight, BF16)


def _pack_cost_volume(weight, dtype):
    if weight.dim() != 5 or weight.shape[1] % 2:
        raise ValueError(f"need a (Co, 2C, 3, 3, 3) weight, got {tuple(weight.shape)}")
    co, c = weight.shape[0], weight.shape[1] // 2
    _check_float32_cuda("weight", weight, (co, 2 * c, 3, 3, 3), weight.device)
    lib = _cv_lib()
    if dtype == BF16:
        out = torch.empty((2, 3, -(-c // 16), 3, 3 * co // 8, 32, 2), dtype=torch.int32,
                          device=weight.device)
        fn, name = lib.cost_volume_tc_pack_bf16_cuda, "cost_volume_tc_pack_bf16_cuda"
    else:
        out = torch.empty((2, 3, -(-c // 8), 3, 3 * co // 8, 32, 4), device=weight.device)
        fn, name = lib.cost_volume_tc_pack_cuda, "cost_volume_tc_pack_cuda"
    err = fn(weight.data_ptr(), co, c, out.data_ptr(), _stream(weight), weight.device.index)
    _raise_on(lib.cost_volume_tc_error_string, err, name)
    return out


def _epilogue(y, mul, add, residual, relu):
    if mul is not None:
        shape = (1, -1) + (1,) * (y.dim() - 2)
        y = y * mul.view(shape) + add.view(shape)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def conv3d_bn_plain(x: torch.Tensor, weight: torch.Tensor, mul: Optional[torch.Tensor] = None,
                    add: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
                    relu: bool = False, stride: int = 1) -> torch.Tensor:
    """x (N, Ci, D, H, W), weight (Co, Ci, 3, 3, 3) -> (N, Co, D', H', W'),
    D' = (D - 1) // stride + 1 (padding 1)."""
    return _epilogue(F.conv3d(x, weight, stride=stride, padding=1), mul, add, residual, relu)


def conv3d_cl1_march_plain(x: torch.Tensor, weight: torch.Tensor,
                           mul: Optional[torch.Tensor] = None,
                           add: Optional[torch.Tensor] = None,
                           residual: Optional[torch.Tensor] = None,
                           relu: bool = False) -> torch.Tensor:
    """conv3d_bn_plain at Co = 1 and stride 1 in csrc/conv3d.cu's arithmetic:
    each output (z, y, x) adds its products x[c, z + kd - 1, y + kh - 1, x +
    kw - 1] * weight[0, c, kd, kh, kw] one at a time in (kd, c, kh, kw)
    order, from 0, taps in the padding included as zeros, each product
    fused into the running sum as the kernel's fmaf does: the product is
    exact in float64, the sum is rounded to float64 and then to float32.
    That double rounding differs from fmaf's single one by an ulp in rare
    cases (about 2^-29 of the additions). Then the epilogue."""
    n, ci, d, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1)).double()
    wd = weight.double()
    acc = xp.new_zeros(n, 1, d, h, w)
    for kd in range(3):
        for c in range(ci):
            for kh in range(3):
                for kw in range(3):
                    acc = (acc + xp[:, c:c + 1, kd:kd + d, kh:kh + h, kw:kw + w]
                           * wd[0, c, kd, kh, kw]).float().double()
    acc = acc.float()
    return _epilogue(acc, mul, add, residual, relu)


def cost_volume_conv_bn_plain(left: torch.Tensor, right: torch.Tensor, weight: torch.Tensor,
                              mul: torch.Tensor, add: torch.Tensor, mindisp4: int,
                              maxdisp4: int, relu: bool = True) -> torch.Tensor:
    """left, right (N, C, H, W) -> conv of the (N, 2C, D, H, W) cost volume,
    (N, Co, D, H, W), D = maxdisp4 - mindisp4."""
    vol = build_cost_volume(left, right, mindisp4, maxdisp4)
    return conv3d_bn_plain(vol, weight, mul, add, relu=relu)


def cost_volume_planes(left: torch.Tensor, right: torch.Tensor, weight: torch.Tensor,
                       conv2d):
    """The tap planes of the cost-volume conv, one per view: (PL, PR), each
    (N, 3 kd, 3 kw, Co, H, W) with
        PL[n, kd, kw, o, y, x] = sum_{c, kh} weight[o, c, kd, kh, kw] * left[n, c, y + kh - 1, x]
    (rows outside [0, H) zero), PR the same of `right` with weight[:, C:].
    Each is one 2D conv with a (3, 1) kernel to 9 Co channels, padding (1,
    0); `conv2d(x, w)` computes it (the float32 conv, or the kernel's
    arithmetic)."""
    n, c, h, w = left.shape
    co = weight.shape[0]

    def planes(x, wv):
        # (Co, C, kd, kh, kw) -> (kd, kw, Co, C, kh): 9 Co output channels of a (3, 1) kernel
        w2 = wv.permute(2, 4, 0, 1, 3).reshape(9 * co, c, 3, 1)
        return conv2d(x, w2).view(n, 3, 3, co, h, w)
    return planes(left, weight[:, :c]), planes(right, weight[:, c:])


def cost_volume_planes_sum(pl: torch.Tensor, pr: torch.Tensor, mindisp4: int,
                           maxdisp4: int) -> torch.Tensor:
    """The cost-volume conv from its tap planes, before the epilogue: (N, Co,
    D, H, W) with
        out[n, o, z, y, x] = sum_{kd, kw} PL[n, kd, kw, o, y, x'] + PR[n, kd, kw, o, y, x' - i]
    over the taps with slice z + kd - 1 in [0, D), x' = x + kw - 1 in [0, W)
    and x' - i in [0, W), i = mindisp4 + z + kd - 1 its disparity: the
    volume's mask depends only on the input column, so the channel and row
    sums of the conv are the planes, and the depth and column taps pick
    them up where the volume is not zero (the depth padding slices are
    zero, as the TPU kernel zeroes them). Summed in (kd, kw) order."""
    n, _, _, co, h, w = pl.shape
    d = maxdisp4 - mindisp4
    dev = pl.device
    cols, z = torch.arange(w, device=dev), torch.arange(d, device=dev)
    out = pl.new_zeros(n, co, h, d, w)
    for kd in range(3):
        zz = z + kd - 1
        disp = mindisp4 + zz
        for kw in range(3):
            xp = cols + kw - 1
            u = xp[None] - disp[:, None]  # (D, W): the right view's column
            ok = (((zz >= 0) & (zz < d))[:, None] & ((xp >= 0) & (xp < w))[None]
                  & (u >= 0) & (u < w))
            a = pl[:, kd, kw][..., xp.clamp(0, w - 1)]  # (N, Co, H, W)
            b = pr[:, kd, kw][..., u.clamp(0, w - 1)]  # (N, Co, H, D, W)
            out += torch.where(ok, a[:, :, :, None] + b, 0.0)
    return out.permute(0, 1, 3, 2, 4)


def cost_volume_conv_bn_planes_plain(left: torch.Tensor, right: torch.Tensor,
                                     weight: torch.Tensor, mul: torch.Tensor,
                                     add: torch.Tensor, mindisp4: int, maxdisp4: int,
                                     relu: bool = True) -> torch.Tensor:
    """cost_volume_conv_bn_plain computed as the kernel computes it: the tap
    planes of each view (two F.conv2d calls), then their masked, shifted
    sums (cost_volume_planes_sum); the volume is never built."""
    pl, pr = cost_volume_planes(left, right, weight,
                                lambda x, w: F.conv2d(x, w, padding=(1, 0)))
    return _epilogue(cost_volume_planes_sum(pl, pr, mindisp4, maxdisp4), mul, add, None, relu)


def cost_volume_conv_bn_3xtf32_plain(left: torch.Tensor, right: torch.Tensor,
                                     weight: torch.Tensor, mul: torch.Tensor,
                                     add: torch.Tensor, mindisp4: int, maxdisp4: int,
                                     relu: bool = True) -> torch.Tensor:
    """cost_volume_conv_bn_planes_plain in the kernel's arithmetic: the
    planes as lo*hi + hi*lo + hi*hi of the split features and weights
    (three F.conv2d calls a view), their sums in float32."""
    def conv2d(x, w):
        (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w)
        return (F.conv2d(xl, wh, padding=(1, 0)) + F.conv2d(xh, wl, padding=(1, 0))
                + F.conv2d(xh, wh, padding=(1, 0)))
    pl, pr = cost_volume_planes(left, right, weight, conv2d)
    return _epilogue(cost_volume_planes_sum(pl, pr, mindisp4, maxdisp4), mul, add, None, relu)


def pack_tf32_cost_volume_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Co, 2C, 3, 3, 3) -> csrc/cost_volume_tc.cu's staged plane weights:
    (2 views, 3 kd, ceil(C / 8), 3 kh, 3 Co / 8, 32 lanes, 4), C padded with
    zeros to a multiple of 8. The planes of view v and depth tap kd are a
    GEMM with K = (channel, kh) and N = (kw, o), column kw * Co + o; lane l
    of N-tile j in chunk cc holds [hi(k), hi(k + 4), lo(k), lo(k + 4)] of
    weight[o, v * C + 8 cc + k, kd, kh, kw], k = l % 4, for column 8 j + l //
    4 (mma.m16n8k8's B fragment), split by split_tf32. The plain version of
    the kernel's own packing, pack_tf32_cost_volume_weight_cuda."""
    co, c = weight.shape[0], weight.shape[1] // 2
    ci8 = -(-c // 8)
    w = F.pad(weight.reshape(co, 2, c, 3, 3, 3), (0, 0, 0, 0, 0, 0, 0, 8 * ci8 - c))
    hi, lo = split_tf32(w)

    def fragments(t):
        # (o, v, cc, k >= 4, k % 4, kd, kh, kw) -> (v, kd, cc, kh, (kw, o), k % 4, k >= 4)
        t = t.reshape(co, 2, ci8, 2, 4, 3, 3, 3).permute(1, 5, 2, 6, 7, 0, 4, 3)
        return t.reshape(2, 3, ci8, 3, 3 * co // 8, 32, 2)
    return torch.cat((fragments(hi), fragments(lo)), dim=-1).contiguous()


def deconv3d_bn_plain(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                      add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """x (N, Ci, D, H, W), weight (Ci, Co, 3, 3, 3) of a torch
    ConvTranspose3d(k=3, s=2, p=1, output_padding=1) -> (N, Co, 2D, 2H, 2W)."""
    y = F.conv_transpose3d(x, weight, stride=2, padding=1, output_padding=1)
    return _epilogue(y, mul, add, residual, relu)


# Per axis of the transposed conv: an even output 2m takes tap k 1 at input
# m; an odd output 2m + 1 takes k 2 at input m and k 0 at input m + 1 (zero
# past the edge). The taps of each output parity, in input offset order.
PARITY_TAPS = ((1,), (2, 0))


def deconv3d_bn_parity_plain(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                             add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                             relu: bool = False, conv3d=F.conv3d) -> torch.Tensor:
    """deconv3d_bn_plain split by output parity, as the kernel computes it:
    each of the 8 classes (pz, py, px) of outputs (2m + pz, 2m' + py, 2m'' +
    px) is a stride-1 conv over the input grid with the taps PARITY_TAPS
    gives per axis (input padded by one on the high side of the odd axes),
    the 8 results interleaved. `conv3d(x, w)` computes each class's conv."""
    n, _, d, h, w = x.shape
    co = weight.shape[1]
    y = x.new_empty(n, co, 2 * d, 2 * h, 2 * w)
    for pz in (0, 1):
        for py in (0, 1):
            for px in (0, 1):
                wc = weight[:, :, list(PARITY_TAPS[pz])][:, :, :, list(PARITY_TAPS[py])]
                wc = wc[..., list(PARITY_TAPS[px])].transpose(0, 1)
                y[:, :, pz::2, py::2, px::2] = conv3d(F.pad(x, (0, px, 0, py, 0, pz)), wc)
    return _epilogue(y, mul, add, residual, relu)


def conv3d_s2_parity_plain(x: torch.Tensor, weight: torch.Tensor,
                           mul: Optional[torch.Tensor] = None, add: Optional[torch.Tensor] = None,
                           residual: Optional[torch.Tensor] = None,
                           relu: bool = False) -> torch.Tensor:
    """conv3d_bn_plain at stride 2 as the bf16 kernel indexes it: the input,
    padded by one before each axis and up to 2 O + 1 after it (O the
    output's size), split into its four (row parity, column parity) planes,
    plane (rp, cp) holding input rows 2 i - 1 + rp and columns 2 j - 1 + cp;
    tap (kd, kh, kw) of output (z, y, x) is plane (kh == 1, kw == 1) at
    depth slice 2 z - 1 + kd, row y + (kh == 2), column x + (kw == 2), its
    27 products summed tap by tap, then the epilogue."""
    od, oh, ow = ((s - 1) // 2 + 1 for s in x.shape[2:])
    d, h, w = x.shape[2:]
    xp = F.pad(x, (1, 2 * ow - w, 1, 2 * oh - h, 1, 2 * od - d))
    planes = {(rp, cp): xp[:, :, :, rp::2, cp::2] for rp in (0, 1) for cp in (0, 1)}
    y = None
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                a, b = int(kh == 2), int(kw == 2)
                plane = planes[int(kh == 1), int(kw == 1)]
                tap = plane[:, :, kd:kd + 2 * od - 1:2, a:a + oh, b:b + ow]
                t = torch.einsum("ncdhw,oc->nodhw", tap, weight[:, :, kd, kh, kw])
                y = t if y is None else y + t
    return _epilogue(y, mul, add, residual, relu)


def conv3d_slice_pair_plain(x: torch.Tensor, weight: torch.Tensor,
                            mul: Optional[torch.Tensor] = None,
                            add: Optional[torch.Tensor] = None,
                            residual: Optional[torch.Tensor] = None,
                            relu: bool = False) -> torch.Tensor:
    """conv3d_bn_plain at stride 1 as the bf16 kernel's slice pairs index it
    (csrc/conv_bf16_wgmma.cu, form kStride1, PAIR): output slices 2 p and 2
    p + 1 are one tall image of 2 H + 2 rows, the first slice's rows, 2 zero
    rows, the second's, padded by a zero row and column on each side; depth
    tap kd stages input slices 2 p + kd - 1 and 2 p + kd (zero outside the
    volume) into it, its 9 taps are shifts of that image, and rows H and H +
    1 of the result are dropped; its 27 products summed tap by tap, then the
    epilogue."""
    n, ci, d, h, w = x.shape
    pairs = (d + 1) // 2
    # xp[:, :, j] is input slice j - 1, for j in [0, 2 pairs + 2)
    xp = F.pad(x, (0, 0, 0, 0, 1, 2 * pairs + 1 - d))
    gap = x.new_zeros(n, ci, pairs, 2, w)
    y = None
    for kd in range(3):
        tall = torch.cat([xp[:, :, kd:kd + 2 * pairs:2], gap,
                          xp[:, :, kd + 1:kd + 1 + 2 * pairs:2]], dim=3)
        tall = F.pad(tall, (1, 1, 1, 1))
        for kh in range(3):
            for kw in range(3):
                tap = tall[:, :, :, kh:kh + 2 * h + 2, kw:kw + w]
                t = torch.einsum("ncphw,oc->nophw", tap, weight[:, :, kd, kh, kw])
                y = t if y is None else y + t
    out = torch.stack([y[:, :, :, :h], y[:, :, :, h + 2:]], dim=3)
    out = out.reshape(n, weight.shape[0], 2 * pairs, h, w)[:, :, :d]
    return _epilogue(out, mul, add, residual, relu)


def deconv3d_bn_3xtf32_plain(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                             add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                             relu: bool = False) -> torch.Tensor:
    """deconv3d_bn_parity_plain in the kernel's arithmetic: each class's
    products as lo*hi + hi*lo + hi*hi of the split input and weights (three
    F.conv3d calls)."""
    def conv3d(xc, wc):
        (xh, xl), (wh, wl) = split_tf32(xc), split_tf32(wc)
        return F.conv3d(xl, wh) + F.conv3d(xh, wl) + F.conv3d(xh, wh)
    return deconv3d_bn_parity_plain(x, weight, mul, add, residual, relu, conv3d)


def pack_tf32_deconv_weight(weight: torch.Tensor) -> torch.Tensor:
    """The torch ConvTranspose3d weight (Ci, Co, 3, 3, 3) -> the transposed
    conv's staged weights in csrc/conv3d_tc.cu: pack_tf32_weight's layout
    of the (Co, Ci) weight weight[c, o, kd, kh, kw], unflipped (the kernel
    sends tap (kd, kh, kw) to the output parity class it feeds). The plain
    version of pack_tf32_deconv_weight_cuda."""
    return pack_tf32_weight(weight.transpose(0, 1))


def conv2d_bn_plain(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                    add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """x (N, Ci, H, W), weight (Co, Ci, 3, 3) -> (N, Co, H, W)."""
    return _epilogue(F.conv2d(x, weight, padding=1), mul, add, residual, relu)


def _up(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


def _bf16_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weight as the bf16 kernels multiply it: rounded to bf16 (nearest
    even), held in float32."""
    return weight.to(BF16).float()


def conv3d_bn_bf16_plain(x: torch.Tensor, weight: torch.Tensor,
                         mul: Optional[torch.Tensor] = None, add: Optional[torch.Tensor] = None,
                         residual: Optional[torch.Tensor] = None, relu: bool = False,
                         stride: int = 1) -> torch.Tensor:
    """The bf16 form's twin: conv3d_bn_plain on x (bf16) and the weight
    rounded to bf16, both cast up to float32, the residual (bf16) too, then
    the output rounded to bf16. At Co = 1 (the classifier) the conv is
    rounded to bf16 before the residual joins and the sum rounded again."""
    y = F.conv3d(x.float(), _bf16_weight(weight), stride=stride, padding=1)
    if weight.shape[0] == 1:
        y = _epilogue(y, mul, add, None, False).to(BF16)
        if residual is not None:
            y = (y.float() + residual.float()).to(BF16)
        return torch.relu(y) if relu else y
    return _epilogue(y, mul, add, _up(residual), relu).to(BF16)


def conv2d_bn_bf16_plain(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                         add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                         relu: bool = False) -> torch.Tensor:
    """conv2d_bn_plain at the bf16 form's rounding points (as
    conv3d_bn_bf16_plain)."""
    y = F.conv2d(x.float(), _bf16_weight(weight), padding=1)
    return _epilogue(y, mul, add, _up(residual), relu).to(BF16)


def deconv3d_bn_bf16_plain(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                           add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                           relu: bool = False) -> torch.Tensor:
    """deconv3d_bn_plain at the bf16 form's rounding points (as
    conv3d_bn_bf16_plain)."""
    y = F.conv_transpose3d(x.float(), _bf16_weight(weight), stride=2, padding=1,
                           output_padding=1)
    return _epilogue(y, mul, add, _up(residual), relu).to(BF16)


def cost_volume_conv_bn_bf16_plain(left: torch.Tensor, right: torch.Tensor,
                                   weight: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                                   mindisp4: int, maxdisp4: int,
                                   relu: bool = True) -> torch.Tensor:
    """cost_volume_conv_bn_plain at the bf16 form's rounding points: the
    bf16 features and the weight rounded to bf16, cast up, the volume's conv
    and epilogue in float32, the output rounded to bf16."""
    return cost_volume_conv_bn_plain(left.float(), right.float(), _bf16_weight(weight), mul, add,
                                     mindisp4, maxdisp4, relu).to(BF16)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two bf16 tensors in bf16 steps: the number
    of representable values from one to the other (+0 and -0 both 0), as
    int32."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def bf16_step(t: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each element's magnitude, float32: 2^(e - 7) for |t|
    in [2^e, 2^(e + 1)) (8 significant bits), at least the smallest normal
    number's."""
    _, e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


# The float32 sums' worst-case rounding a term, the tensor cores' truncating
# adds included (2^-23 an add, and a stage's sums promoted with rounding):
# a correct bf16 kernel and its twin, summing K terms of magnitudes adding
# up to M in other orders, differ before their one rounding by at most
# K * F32_SUM_ERR * M.
F32_SUM_ERR = 2.0 ** -22


def bf16_agreement(got: torch.Tensor, want: torch.Tensor, floor=None) -> dict:
    """A bf16 kernel's output against its twin's: "equal" (the share of
    elements bit-equal), "beyond" (elements more than one bf16 step apart,
    at the larger magnitude, plus `floor`: a tensor or number bounding the
    difference of the float32 sums before the rounding, which exceeds a
    step where the sums cancel to much less than their terms), "max_ulps"
    (bf16_ulps over all elements) and "max_ulps_clear" (over the elements
    whose floor is under a step and whose two values share a binade: two
    values either side of a power of two, or of zero, are a step of the
    larger apart in more than one representable value, and "beyond" holds
    them)."""
    ulps = bf16_ulps(got, want)
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    step = bf16_step(torch.maximum(g.abs(), w.abs()))
    floor = torch.zeros_like(step) if floor is None else torch.as_tensor(floor).expand_as(step)
    clear = (floor < step) & (bf16_step(g) == bf16_step(w)) & ((g < 0) == (w < 0))
    return {"equal": float((ulps == 0).float().mean()), "beyond": int((diff > step + floor).sum()),
            "max_ulps": int(ulps.max()),
            "max_ulps_clear": int(ulps[clear].max()) if bool(clear.any()) else 0}


def _bf16_words(t: torch.Tensor) -> torch.Tensor:
    """(..., 2) values -> (...) int32 words of two bf16 (rounded to nearest
    even), the first in the lower half."""
    return t.to(BF16).contiguous().view(torch.int32)[..., 0]


# pack_wgmma_weight's forms: the conv weight (2D or 3D), the
# ConvTranspose3d weight, and a 3D conv weight for its input gradient
# (csrc/conv_bf16_wgmma.cu's PackForm, the 2D and 3D conv weights by dim)
WGMMA_PACK_FORMS = ("conv", "deconv", "flip")


def pack_wgmma_weight(weight: torch.Tensor, form: str) -> torch.Tensor:
    """The bf16 forms of rows 3 and 5-8 (csrc/conv_bf16_wgmma.cu): with
    `form` "conv" the conv weight (Co, Ci, 3, 3) or (Co, Ci, 3, 3, 3), with
    "deconv" the ConvTranspose3d weight (Ci, Co, 3, 3, 3) unflipped, with
    "flip" flip_transpose(weight) of a conv weight (the input gradient's
    conv, Co and Ci swapped), -> bf16 (ceil(Ci / 16), wkd, 9 taps (kh, kw),
    Co / 8, 2, 8, 8), wkd 1 (the 2D weight) or 3 depth taps: element (cc,
    kd, tap, j, half, r, k) is the weight from input channel 16 cc + 8 half
    + k to output channel 8 j + r, rounded to bf16 (nearest even), zero past
    Ci. A tap's (16 channels x Co) block is wgmma's B operand in K-major
    core matrices (8 output channels x 8 input channels); a stage's 9 taps
    are one contiguous slab. The plain version of pack_wgmma_weight_cuda."""
    if form not in WGMMA_PACK_FORMS:
        raise ValueError(f"form must be one of {WGMMA_PACK_FORMS}, got {form!r}")
    if form == "deconv":
        w5 = weight.transpose(0, 1)
    elif form == "flip":
        w5 = flip_transpose(weight)
    else:
        w5 = weight[:, :, None] if weight.dim() == 4 else weight
    co, ci, kd = w5.shape[:3]
    ci16 = -(-ci // 16)
    w = F.pad(w5, (0, 0, 0, 0, 0, 0, 0, 16 * ci16 - ci))
    # (j, r, cc, half, k, kd, tap) -> (cc, kd, tap, j, half, r, k)
    w = w.reshape(co // 8, 8, ci16, 2, 8, kd, 9).permute(2, 5, 6, 0, 3, 1, 4)
    return w.to(BF16).contiguous()


def pack_wgmma_weight_cuda(weight: torch.Tensor, form: str) -> torch.Tensor:
    """pack_wgmma_weight(weight, form) in one launch of
    csrc/conv_bf16_wgmma.cu's packing on the current stream (weight
    float32, contiguous, on the card)."""
    if form not in WGMMA_PACK_FORMS:
        raise ValueError(f"form must be one of {WGMMA_PACK_FORMS}, got {form!r}")
    if weight.dim() != 5 and (form != "conv" or weight.dim() != 4):
        raise ValueError(f"need a (Co, Ci, 3, 3) or 3x3x3 weight for form {form!r}, got "
                         f"{tuple(weight.shape)}")
    _check_float32_cuda("weight", weight, tuple(weight.shape), weight.device)
    co, ci = weight.shape[:2] if form == "conv" else weight.shape[1::-1]
    if co not in CHANNELS:
        raise ValueError(f"the packing takes Co in {CHANNELS}, got {co}")
    code = {"conv": 0 if weight.dim() == 4 else 2, "deconv": 1, "flip": 3}[form]
    out = torch.empty((-(-ci // 16), 1 if weight.dim() == 4 else 3, 9, co // 8, 2, 8, 8),
                      dtype=BF16, device=weight.device)
    lib = _wg_lib()
    err = lib.conv_bf16_wgmma_pack_cuda(weight.data_ptr(), co, ci, code, out.data_ptr(),
                                        _stream(weight), weight.device.index)
    _raise_on(lib.conv_bf16_wgmma_error_string, err, "conv_bf16_wgmma_pack_cuda")
    return out


def pack_bf16_cost_volume_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Co, 2C, 3, 3, 3) -> csrc/cost_volume_tc.cu's bf16 staged plane
    weights, int32 words of two bf16: (2 views, 3 kd, ceil(C / 16), 3 kh, 3
    Co / 8, 32 lanes, 2), C padded with zeros to a multiple of 16; lane l of
    N-tile j in chunk cc holds in word e the weights of channels v C + 16 cc
    + 8 e + 2 (l % 4) and the next one for plane column 8 j + l // 4 (column
    kw Co + o), rounded to bf16. The plain version of
    pack_bf16_cost_volume_weight_cuda."""
    co, c = weight.shape[0], weight.shape[1] // 2
    ci16 = -(-c // 16)
    w = F.pad(weight.reshape(co, 2, c, 3, 3, 3), (0, 0, 0, 0, 0, 0, 0, 16 * ci16 - c))
    # (o, v, cc, e, l % 4, pair, kd, kh, kw) -> (v, kd, cc, kh, (kw, o), l % 4, e, pair)
    w = w.reshape(co, 2, ci16, 2, 4, 2, 3, 3, 3).permute(1, 6, 2, 7, 8, 0, 4, 3, 5)
    return _bf16_words(w.reshape(2, 3, ci16, 3, 3 * co // 8, 32, 2, 2)).contiguous()


def _check_float32_cuda(name: str, t: torch.Tensor, shape, device) -> None:
    _check_cuda(name, t, shape, device, torch.float32)


def _check_cuda(name: str, t: torch.Tensor, shape, device, dtype) -> None:
    if t.dtype != dtype or not t.is_cuda:
        raise ValueError(f"{name} must be a {str(dtype).split('.')[-1]} CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_input(name: str, t: torch.Tensor, dims: int, dtype=torch.float32) -> None:
    if t.dim() != dims:
        raise ValueError(f"{name} must have {dims} dims, got {tuple(t.shape)}")
    _check_cuda(name, t, t.shape, t.device, dtype)


def _epilogue_args(co: int, mul, add, residual, out_shape, device, channels=CHANNELS,
                   dtype=torch.float32):
    if co not in channels:
        raise ValueError(f"the kernel takes Co in {channels}, got {co}")
    if mul is None:
        mul = torch.ones(co, device=device)
        add = torch.zeros(co, device=device)
    _check_float32_cuda("mul", mul, (co,), device)
    _check_float32_cuda("add", add, (co,), device)
    if residual is not None:
        _check_cuda("residual", residual, out_shape, device, dtype)
    return mul, add, None if residual is None else residual.data_ptr()


def _raise_on(error_string, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(err).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _counts(dtype) -> dict:
    return launches_bf16 if dtype == BF16 else launches


def _suffix(dtype) -> str:
    """The C entry points' suffix of the form: "" (float32) or "_bf16"."""
    return "_bf16" if dtype == BF16 else ""


def conv3d_bn_cuda(x: torch.Tensor, weight: torch.Tensor, mul: Optional[torch.Tensor] = None,
                   add: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
                   relu: bool = False, stride: int = 1) -> torch.Tensor:
    """Launch csrc/conv3d_tc.cu (Co 32, 64) or csrc/conv3d.cu (Co 1) on the
    current stream; same contract as conv3d_bn_plain."""
    build.forward_only("conv3d_bn_cuda", x, weight, mul, add, residual)
    return _conv3d_counted(x, weight, mul, add, residual, relu, stride, torch.float32)


def conv3d_bn_bf16_cuda(x: torch.Tensor, weight: torch.Tensor,
                        mul: Optional[torch.Tensor] = None, add: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None, relu: bool = False,
                        stride: int = 1) -> torch.Tensor:
    """Launch csrc/conv_bf16_wgmma.cu's 3D conv (Co 32, 64; its weight
    packing, then the conv) or csrc/conv3d.cu's bf16 form (Co 1) on the
    current stream: x and residual bf16, the weight, mul and add float32;
    same contract as conv3d_bn_bf16_plain."""
    build.forward_only("conv3d_bn_bf16_cuda", x, weight, mul, add, residual)
    return _conv3d_counted(x, weight, mul, add, residual, relu, stride, BF16)


def _conv3d_counted(x, weight, mul, add, residual, relu, stride, dtype):
    out = _conv3d_launch(x, weight, mul, add, residual, relu, stride, dtype=dtype)
    _counts(dtype)["conv3d_s2" if stride == 2 else "conv3d_cl1" if weight.shape[0] == 1
                   else "conv3d"] += 1
    return out


def _conv3d_launch(x, weight, mul=None, add=None, residual=None, relu=False, stride=1,
                   flip=False, dtype=torch.float32):
    """One launch of the conv3d kernel in the form of `dtype` (x, residual
    and output of that dtype), not counted; with `flip`, the conv with
    flip_transpose(weight)."""
    _check_input("x", x, 5, dtype)
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    n, ci, d, h, w = x.shape
    co = weight.shape[1] if flip else weight.shape[0]
    out_shape = (n, co, *((s - 1) // stride + 1 for s in (d, h, w)))
    _check_float32_cuda("weight", weight, (ci, co, 3, 3, 3) if flip else (co, ci, 3, 3, 3),
                        x.device)
    mul, add, res = _epilogue_args(co, mul, add, residual, out_shape, x.device,
                                   CHANNELS + ((1,) if stride == 1 else ()), dtype)
    out = torch.empty(out_shape, dtype=dtype, device=x.device)
    sfx = _suffix(dtype)
    if co == 1 and not flip:
        lib = _lib()
        # the bf16 form multiplies the weight rounded to bf16, held in float32
        wt = F.pad((_bf16_weight if dtype == BF16 else lambda t: t)(weight.reshape(ci, 27)),
                   (0, 1))
        err = getattr(lib, f"conv3d_bn{sfx}_cuda")(
            x.data_ptr(), n, ci, d, h, w, wt.data_ptr(), mul.data_ptr(), add.data_ptr(), res,
            int(relu), out.data_ptr(), _stream(x), x.device.index)
        _raise_on(lib.conv3d_error_string, err, f"conv3d_bn{sfx}_cuda")
        return out
    if dtype == BF16:
        lib, name = _wg_lib(), "conv3d_bf16_wgmma_cuda"
        _check_width(FORM_STRIDE2 if stride == 2 else FORM_STRIDE1, co, w)
        wt = pack_wgmma_weight_cuda(weight, "flip" if flip else "conv")
        err_string = lib.conv_bf16_wgmma_error_string
    else:
        lib, name = _tc_lib(), "conv3d_tc_cuda"
        wt = _pack_conv(weight, flip)
        err_string = lib.conv3d_tc_error_string
    err = getattr(lib, name)(
        x.data_ptr(), n, ci, d, h, w, stride, wt.data_ptr(), co, mul.data_ptr(), add.data_ptr(),
        res, int(relu), out.data_ptr(), _stream(x), x.device.index)
    _raise_on(err_string, err, name)
    return out


def cost_volume_conv_bn_cuda(left: torch.Tensor, right: torch.Tensor, weight: torch.Tensor,
                             mul: torch.Tensor, add: torch.Tensor, mindisp4: int,
                             maxdisp4: int, relu: bool = True) -> torch.Tensor:
    """Launch csrc/cost_volume_tc.cu (its weight packing, the tap planes,
    their sums) on the current stream; same contract as
    cost_volume_conv_bn_plain. The planes, (2, N, H, 9, Co, W), are scratch
    of this call."""
    build.forward_only("cost_volume_conv_bn_cuda", left, right, weight, mul, add)
    return _cost_volume_launch(left, right, weight, mul, add, mindisp4, maxdisp4, relu,
                               torch.float32)


def cost_volume_conv_bn_bf16_cuda(left: torch.Tensor, right: torch.Tensor,
                                  weight: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                                  mindisp4: int, maxdisp4: int,
                                  relu: bool = True) -> torch.Tensor:
    """Launch the bf16 form of csrc/cost_volume_tc.cu (its bf16 weight
    packing, the tap planes in float32, their sums) on the current stream:
    left and right bf16; same contract as cost_volume_conv_bn_bf16_plain."""
    build.forward_only("cost_volume_conv_bn_bf16_cuda", left, right, weight, mul, add)
    return _cost_volume_launch(left, right, weight, mul, add, mindisp4, maxdisp4, relu, BF16)


def _cost_volume_launch(left, right, weight, mul, add, mindisp4, maxdisp4, relu, dtype):
    _check_input("left", left, 4, dtype)
    n, c, h, w = left.shape
    d = maxdisp4 - mindisp4
    if d < 1:
        raise ValueError(f"empty disparity range [{mindisp4}, {maxdisp4})")
    _check_cuda("right", right, left.shape, left.device, dtype)
    co = weight.shape[0]
    _check_float32_cuda("weight", weight, (co, 2 * c, 3, 3, 3), left.device)
    mul, add, _ = _epilogue_args(co, mul, add, None, None, left.device)
    lib = _cv_lib()
    wt = _pack_cost_volume(weight, dtype)
    planes = torch.empty((2, n, h, 9, co, w), device=left.device)
    out = torch.empty((n, co, d, h, w), dtype=dtype, device=left.device)
    name = f"cost_volume_tc{_suffix(dtype)}_cuda"
    err = getattr(lib, name)(
        left.data_ptr(), right.data_ptr(), n, c, h, w, mindisp4, d, wt.data_ptr(), co,
        mul.data_ptr(), add.data_ptr(), int(relu), planes.data_ptr(), out.data_ptr(),
        _stream(left), left.device.index)
    _raise_on(lib.cost_volume_tc_error_string, err, name)
    _counts(dtype)["cost_volume_conv"] += 1
    return out


def deconv3d_bn_cuda(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                     add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                     relu: bool = False) -> torch.Tensor:
    """Launch csrc/conv3d_tc.cu's transposed conv (its weight packing, then
    the conv) on the current stream; same contract as deconv3d_bn_plain."""
    build.forward_only("deconv3d_bn_cuda", x, weight, mul, add, residual)
    return _deconv3d_launch(x, weight, mul, add, residual, relu, torch.float32)


def deconv3d_bn_bf16_cuda(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                          add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                          relu: bool = False) -> torch.Tensor:
    """Launch csrc/conv_bf16_wgmma.cu's transposed conv (its weight packing,
    then the conv) on the current stream; same contract as
    deconv3d_bn_bf16_plain."""
    build.forward_only("deconv3d_bn_bf16_cuda", x, weight, mul, add, residual)
    return _deconv3d_launch(x, weight, mul, add, residual, relu, BF16)


def _deconv3d_launch(x, weight, mul, add, residual, relu, dtype):
    _check_input("x", x, 5, dtype)
    n, ci, d, h, w = x.shape
    co = weight.shape[1]
    out_shape = (n, co, 2 * d, 2 * h, 2 * w)
    _check_float32_cuda("weight", weight, (ci, co, 3, 3, 3), x.device)
    mul, add, res = _epilogue_args(co, mul, add, residual, out_shape, x.device, dtype=dtype)
    out = torch.empty(out_shape, dtype=dtype, device=x.device)
    if dtype == BF16:
        lib, name = _wg_lib(), "deconv3d_bf16_wgmma_cuda"
        _check_width(FORM_TRANSPOSED, co, w)
        wt = pack_wgmma_weight_cuda(weight, "deconv")
        err = lib.deconv3d_bf16_wgmma_cuda(x.data_ptr(), n, ci, d, h, w, wt.data_ptr(), co,
                                           mul.data_ptr(), add.data_ptr(), res, int(relu),
                                           out.data_ptr(), _stream(x), x.device.index)
        _raise_on(lib.conv_bf16_wgmma_error_string, err, name)
    else:
        lib, name = _tc_lib(), "deconv3d_tc_cuda"
        wt = _pack_deconv(weight)
        err = lib.deconv3d_tc_cuda(x.data_ptr(), n, ci, d, h, w, wt.data_ptr(), co,
                                   mul.data_ptr(), add.data_ptr(), res, int(relu),
                                   out.data_ptr(), _stream(x), x.device.index)
        _raise_on(lib.conv3d_tc_error_string, err, name)
    _counts(dtype)["deconv3d"] += 1
    return out


# csrc/conv_bf16_wgmma.cu's forms (its ConvForm): the stride-1 conv (2D or
# 3D), the transposed conv, the stride-2 conv
FORM_STRIDE1, FORM_TRANSPOSED, FORM_STRIDE2 = 0, 1, 2
_FORM_NAMES = {FORM_STRIDE1: "stride-1 conv", FORM_TRANSPOSED: "transposed conv",
               FORM_STRIDE2: "stride-2 conv"}


@functools.cache
def _widest(form: int, co: int) -> int:
    return _wg_lib().conv_bf16_wgmma_max_width(form, co)


def _check_width(form: int, co: int, w: int) -> None:
    """Raise on a Co or an input width a form of csrc/conv_bf16_wgmma.cu
    does not take: every width up to the library's conv_bf16_wgmma_max_width
    plans a tile at every height (its M-tiles hold a halo row of W + 1
    positions, at stride 2 of the output's width + 1, and its staging, halos
    and output tile fit in shared memory)."""
    name = _FORM_NAMES[form]
    if co not in CHANNELS:
        raise ValueError(f"the bf16 {name} takes Co in {CHANNELS}, got {co}")
    widest = _widest(form, co)
    if w > widest:
        raise ValueError(f"the bf16 {name} at Co {co} takes inputs up to {widest} wide, got "
                         f"W = {w}")


def conv2d_bn_cuda(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                   add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                   relu: bool = False) -> torch.Tensor:
    """Launch csrc/conv3d_tc.cu's 2D conv (its weight packing, then the
    conv) on the current stream; same contract as conv2d_bn_plain."""
    build.forward_only("conv2d_bn_cuda", x, weight, mul, add, residual)
    return _conv2d_launch(x, weight, mul, add, residual, relu, torch.float32)


def conv2d_bn_bf16_cuda(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor,
                        add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """Launch csrc/conv_bf16_wgmma.cu's 2D conv (its weight packing, then
    the conv) on the current stream; same contract as conv2d_bn_bf16_plain."""
    build.forward_only("conv2d_bn_bf16_cuda", x, weight, mul, add, residual)
    return _conv2d_launch(x, weight, mul, add, residual, relu, BF16)


def _conv2d_launch(x, weight, mul, add, residual, relu, dtype):
    _check_input("x", x, 4, dtype)
    n, ci, h, w = x.shape
    co = weight.shape[0]
    _check_float32_cuda("weight", weight, (co, ci, 3, 3), x.device)
    mul, add, res = _epilogue_args(co, mul, add, residual, (n, co, h, w), x.device, dtype=dtype)
    out = torch.empty((n, co, h, w), dtype=dtype, device=x.device)
    if dtype == BF16:
        lib, name = _wg_lib(), "conv2d_bf16_wgmma_cuda"
        _check_width(FORM_STRIDE1, co, w)
        wt = pack_wgmma_weight_cuda(weight, "conv")
        err = lib.conv2d_bf16_wgmma_cuda(x.data_ptr(), n, ci, h, w, wt.data_ptr(), co,
                                         mul.data_ptr(), add.data_ptr(), res, int(relu),
                                         out.data_ptr(), _stream(x), x.device.index)
        _raise_on(lib.conv_bf16_wgmma_error_string, err, name)
    else:
        lib, name = _tc_lib(), "conv2d_tc_cuda"
        wt = _pack_conv(weight, False)
        err = lib.conv2d_tc_cuda(x.data_ptr(), n, ci, h, w, wt.data_ptr(), co, mul.data_ptr(),
                                 add.data_ptr(), res, int(relu), out.data_ptr(), _stream(x),
                                 x.device.index)
        _raise_on(lib.conv3d_tc_error_string, err, name)
    _counts(dtype)["conv2d"] += 1
    return out


def conv3d_bn(x, weight, mul=None, add=None, residual=None, relu=False,
              stride=1) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; a bf16 x
    takes the bf16 form (kernel or twin)."""
    if x.dtype == BF16:
        if x.is_cuda:
            return conv3d_bn_bf16_cuda(x, weight, mul, add, residual, relu, stride)
        return conv3d_bn_bf16_plain(x, weight, mul, add, residual, relu, stride)
    if x.is_cuda:
        return conv3d_bn_cuda(x, weight, mul, add, residual, relu, stride)
    return conv3d_bn_plain(x, weight, mul, add, residual, relu, stride)


def cost_volume_conv_bn(left, right, weight, mul, add, mindisp4, maxdisp4,
                        relu=True) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; bf16 features
    take the bf16 form (kernel or twin)."""
    if left.dtype == BF16:
        if left.is_cuda:
            return cost_volume_conv_bn_bf16_cuda(left, right, weight, mul, add, mindisp4,
                                                 maxdisp4, relu)
        return cost_volume_conv_bn_bf16_plain(left, right, weight, mul, add, mindisp4,
                                              maxdisp4, relu)
    if left.is_cuda:
        return cost_volume_conv_bn_cuda(left, right, weight, mul, add, mindisp4, maxdisp4, relu)
    return cost_volume_conv_bn_plain(left, right, weight, mul, add, mindisp4, maxdisp4, relu)


def deconv3d_bn(x, weight, mul, add, residual=None, relu=False) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; a bf16 x
    takes the bf16 form (kernel or twin)."""
    if x.dtype == BF16:
        if x.is_cuda:
            return deconv3d_bn_bf16_cuda(x, weight, mul, add, residual, relu)
        return deconv3d_bn_bf16_plain(x, weight, mul, add, residual, relu)
    if x.is_cuda:
        return deconv3d_bn_cuda(x, weight, mul, add, residual, relu)
    return deconv3d_bn_plain(x, weight, mul, add, residual, relu)


def conv2d_bn(x, weight, mul, add, residual=None, relu=False) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; a bf16 x
    takes the bf16 form (kernel or twin)."""
    if x.dtype == BF16:
        if x.is_cuda:
            return conv2d_bn_bf16_cuda(x, weight, mul, add, residual, relu)
        return conv2d_bn_bf16_plain(x, weight, mul, add, residual, relu)
    if x.is_cuda:
        return conv2d_bn_cuda(x, weight, mul, add, residual, relu)
    return conv2d_bn_plain(x, weight, mul, add, residual, relu)


def flip_transpose(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) -> (Ci, Co, 3, 3, 3) flipped in every spatial dim:
    for stride 1 and padding 1, the input gradient of conv(x, weight) is
    conv(dy, flip_transpose(weight))."""
    return weight.flip((2, 3, 4)).transpose(0, 1).contiguous()


def conv3d_train_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The raw stride-1 pad-1 3x3x3 conv, differentiable by autograd: the
    train form's plain version."""
    return F.conv3d(x, weight, padding=1)


def conv3d_train_dx_plain(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The input gradient of conv3d_train_plain(x, weight) for output
    gradient dy, computed as the kernel computes it."""
    return F.conv3d(dy, flip_transpose(weight), padding=1)


def conv3d_train_bf16_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The bf16 train form's plain version, differentiable by autograd: x
    bf16 and the weight rounded to bf16, both cast up, the float32 conv
    rounded once to bf16. Its input gradient comes out as the float32 conv
    of the bf16 output gradient with the rounded weights, rounded to bf16;
    its weight gradient as the float32 weight gradient rounded to bf16,
    widened to the float32 weight (packed_conv_train's bf16 arithmetic)."""
    return F.conv3d(x.float(), weight.to(BF16).float(), padding=1).to(BF16)


def conv3d_train_dx_bf16_plain(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The input gradient of conv3d_train_bf16_plain(x, weight) for the bf16
    output gradient dy, as the bf16 kernel computes it: dy with the flipped
    weights rounded to bf16, in float32, rounded once."""
    return F.conv3d(dy.float(), _bf16_weight(flip_transpose(weight)), padding=1).to(BF16)


def conv3d_train_cuda(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The train form's forward with the identity epilogue, in the form of
    x's dtype: csrc/conv3d_tc.cu (float32) or csrc/conv_bf16_wgmma.cu
    (bf16)."""
    out = _conv3d_launch(x, weight, dtype=x.dtype)
    _counts(x.dtype)["conv3d_train"] += 1
    return out


def conv3d_train_dx_cuda(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The train form's input gradient: the stride-1 conv of dy with the
    flipped, channel-transposed weights (Ci = Co in every trunk site), in
    the form of dy's dtype (csrc/conv3d_tc.cu or csrc/conv_bf16_wgmma.cu,
    as the forward)."""
    out = _conv3d_launch(dy.contiguous(), weight, flip=True, dtype=dy.dtype)
    _counts(dy.dtype)["conv3d_train"] += 1
    return out


class _Conv3dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return conv3d_train_cuda(x, weight)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.to(x.dtype)  # JAX's _pct_bwd: the cotangent at the conv's dtype
        dx = conv3d_train_dx_cuda(dy, weight) if ctx.needs_input_grad[0] else None
        dk = None
        if ctx.needs_input_grad[1]:
            # a bf16 x: the weight gradient of the bf16 tensors, rounded to
            # bf16 (the gradient of JAX's bf16 kernel), widened to the weight
            dk = torch.nn.grad.conv3d_weight(x, weight.shape, dy, padding=1).to(weight.dtype)
        return dx, dk


def conv3d_train(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (N, Ci, D, H, W) float32 or bf16, weight (Co, Ci, 3, 3, 3) float32
    -> the raw conv (N, Co, D, H, W) at x's dtype, differentiable in x and
    weight. CUDA tensors take the kernel forward and backward (Co and Ci in
    CHANNELS), CPU tensors the plain version (the bf16 one for a bf16 x)."""
    if x.is_cuda:
        return _Conv3dTrain.apply(x, weight)
    if x.dtype == BF16:
        return conv3d_train_bf16_plain(x, weight)
    return conv3d_train_plain(x, weight)
