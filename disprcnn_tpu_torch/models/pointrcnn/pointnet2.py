"""PointNet++ set abstraction and feature propagation (counterpart of
disprcnn_tpu/models/pointrcnn/pointnet2.py; reference pointnet2_modules.py
and pytorch_utils.SharedMLP).

Layout: points (B, N, 3), features (B, N, C). Module and parameter names
are the Flax ones (``mlp{i}``, ``bn{i}``, ``mlp_scale{i}``, ``sa{k}``,
``fp{i}``), so utils/weights.py maps the JAX variables one to one.

Where the TPU runs a Pallas kernel, the port runs its CUDA kernel (plain
version on the CPU), with the JAX package's gates in the JAX order
(disprcnn_tpu pointnet2.py:194-248):

- a ball-grouped scale whose first layer has >= ``sa_min_c0`` channels
  (64, the shipped DISPRCNN_SA_MIN_C0) and that has input features: the
  fused SA kernel, row 10 (ops/cuda/sa.py), with mlp0 factored as the TPU
  does: its feature columns applied at the N source points plus its bias,
  its xyz columns on the float32-centred neighbour offsets inside the
  kernel;
- in eval, any other scale of >= ``sa_min_c0`` channels, and every such
  scale when the SA family is off: the ``pool`` route. The factored
  grouped pre-activation (mlp0's feature columns gathered, plus the xyz
  term; the xyz term plus mlp0's bias without features) is formed per
  chunk of clouds of at most GROUPED_CHUNK_ELEMS float32 values, and the
  grouped MLP + max kernel, row 12 (ops/cuda/grouped_mlp.py), takes each
  chunk;
- feature propagation with both known points and skip features: the fused
  FP kernel, row 13 (ops/cuda/fp.py).

``kernels_off`` is the port's form of DISPRCNN_PALLAS_DISABLE for these
families: a set of the JAX tags "sa", "pool" and "fp", each of which sends
its scales down the next route (SA off: the pool route; pool off: the plain
arithmetic; FP off: the plain interpolation and MLP). It is a route the
caller asks for; nothing sets it on a failure.

The other scales (RPN SA0, below the gate and without features; the
group-all scale) and FP level 0 (no skip features) run the XLA path's
arithmetic in plain PyTorch, as the TPU runs them in XLA.

In train mode:

- a BN-free MLP (the RCNN) scale with features and >= ``sa_min_c0``
  channels takes the SA kernel's train form (``sa_ball_mlp_max_train``:
  the kernel forward, the plain version's backward; pointnet2.py:209-219),
  whether or not "sa" is off (JAX's train gate reads its own tag,
  "satrain");
- an MLP with BN (the 3D RPN, stage 3) takes the plain grouped route at
  every scale: the grouped pre-activation, train-mode BN with Flax's
  statistics over every axis but the channels (``batch_norm_train``:
  (B, M, S) for a grouped scale, (B, N) for FP; every instance row and
  every repeated ball slot counted, as JAX counts them), ReLU, the later
  layers, the max over the ball (JAX's literal grouped path,
  pointnet2.py:392-394);
- feature propagation takes the plain interpolation and MLP (JAX's FP
  gate has ``not train``, pointnet2.py:481-487).

No kernel of rows 10-13 runs in a train-mode MLP with BN.

The compute dtype (``dtype``, TPU.COMPUTE_DTYPE): float32, or bfloat16 as
the JAX package's ``Pointnet2MSG(dtype=jnp.bfloat16)`` computes, in eval
and in train mode; the parameters stay float32. In bf16 the plain layers run at Flax's
rounding points (``dense``, ``SharedMLP.norm``): each dense layer's input
and weight rounded to bf16, the exact products summed in float32 and
rounded once to bf16, then the bias (rounded to bf16) added in bf16 (Flax
adds it after the product has been rounded, so no fused addmm); eval BN
in float32 from the bf16 input, rounded once (``psmnet.bn_eval``); ReLU
and the max on bf16. mlp0's xyz columns on the centred offsets are JAX's
unrolled K = 3 sum (pointnet2.py:69-80): the offsets formed in float32 and
rounded to bf16, three bf16 products and two bf16 adds, (t0 + t1) + t2;
its feature columns ``v`` a bf16 dense layer, then + b0 in bf16
(pointnet2.py:298-301). The kernels take their bf16 forms (rows 10, 12
and 13: ops/cuda/sa.py, grouped_mlp.py and fp.py; row 12's on the pool
route, the SA-off route of a bf16 model). The points stay float32
throughout, as JAX keeps them.

In train mode at bf16 (ROADMAP A8.4) the BN MLPs' train BN is Flax's
``BatchNorm(dtype=bfloat16)`` (psmnet.batch_norm_train on the bf16 dense
output: float32 statistics, one rounding), and the BN-free scales that
take the SA kernel's train form (JAX's gate, pointnet2.py:209-218, which
takes it only for bf16 models) take its bf16 form (ops/cuda/sa.py: row
10's bf16 kernel forward, autograd of the oracle's bf16 arithmetic
backward).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.cuda.fp import fp_fused
from ...ops.cuda.grouped_mlp import grouped_mlp_max
from ...ops.cuda.sa import sa_ball_mlp_max, sa_ball_mlp_max_train
from ...ops.points import (ball_query, fps_or_identity, gather_points, group_points,
                           three_interpolate, three_nn, three_nn_interpolate_weights)
from ..psmnet.psmnet import batch_norm_train

BF16 = torch.bfloat16

BN_EPS = 1e-5
SA_MIN_C0 = 64  # disprcnn_tpu pointnet2._sa_min_c0, the shipped gate
# the JAX package's DISPRCNN_PALLAS_DISABLE tags of the PointNet++ families
KERNEL_TAGS = ("sa", "pool", "fp")
# The pool route forms the grouped pre-activation per chunk of clouds of at
# most this many float32 values (1 GiB): RCNN SA0's whole tensor is 8.6 GB
# at the headline budget (2048 x 128 x 64 x 128) and 26.8 GB for a
# reference-budget block of 6400 clouds, before the gather's temporaries.
GROUPED_CHUNK_ELEMS = 1 << 28


def kernel_tags(tags) -> frozenset:
    """`tags` as a frozenset of KERNEL_TAGS; raises ValueError on any other."""
    tags = frozenset(tags)
    unknown = sorted(tags - set(KERNEL_TAGS))
    if unknown:
        raise ValueError(f"unknown kernel family {unknown}: the tags are {KERNEL_TAGS}")
    return tags


def batch_norm_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Eval BN over the last axis as Flax applies it: (x - mean) *
    (rsqrt(var + eps) * scale) + bias."""
    return (x - bn.running_mean) * (torch.rsqrt(bn.running_var + BN_EPS) * bn.weight) + bn.bias


def product_bf16(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight.t() as a bf16 dot: x and the (out, in) weight rounded to
    bf16, their exact products summed in float32, rounded once to bf16."""
    return (x.to(BF16).float() @ weight.to(BF16).float().t()).to(BF16)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flax's nn.Dense at the compute dtype: float32 through the layer; bf16
    as product_bf16, then the bias rounded to bf16 and added in bf16 (the
    module doc)."""
    if dtype != BF16:
        return layer(x)
    y = product_bf16(x, layer.weight)
    return y if layer.bias is None else y + layer.bias.to(BF16)


class SharedMLP(nn.Module):
    """Dense (+ BatchNorm: running statistics in eval, batch statistics in
    train) + ReLU layers over the last axis. ``mlp0`` takes ``in_channels``
    inputs; with BN the dense layers have no bias. Built in eval mode, as
    the JAX modules default to train=False. ``dtype`` is the compute dtype
    (float32, or bf16 in eval: the module doc)."""

    def __init__(self, channels: Sequence[int], in_channels: int, use_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = tuple(channels)
        self.use_bn = use_bn
        self.dtype = dtype
        cin = in_channels
        for i, c in enumerate(self.channels):
            setattr(self, f"mlp{i}", nn.Linear(cin, c, bias=not use_bn))
            if use_bn:
                setattr(self, f"bn{i}", nn.BatchNorm1d(c, eps=BN_EPS))
            cin = c
        self.eval()  # train mode only on request (model.train())

    def dense(self, i: int) -> nn.Linear:
        return getattr(self, f"mlp{i}")

    def bn_affine(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mul, add) of eval BN i: y = x * mul + add."""
        bn = getattr(self, f"bn{i}")
        mul = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        return mul, bn.bias - bn.running_mean * mul

    def norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if not self.use_bn:
            return x
        bn = getattr(self, f"bn{i}")
        if self.training:
            return batch_norm_train(bn, x, axis=-1)
        return batch_norm_eval(bn, x).to(x.dtype)

    def folded_chain(self, start: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """[(W (Ci, Co), b (Co,))] of layers start.., the eval BN folded in,
        contiguous (the fused kernels' weights)."""
        out = []
        for i in range(start, len(self.channels)):
            w = self.dense(i).weight.t()
            if self.use_bn:
                mul, add = self.bn_affine(i)
                out.append(((w * mul[None, :]).contiguous(), add.contiguous()))
            else:
                out.append((w.contiguous(), self.dense(i).bias))
        return out

    def layers_from(self, x: torch.Tensor, start: int) -> torch.Tensor:
        for i in range(start, len(self.channels)):
            x = torch.relu(self.norm(i, dense(self.dense(i), x, self.dtype)))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_from(x, 0)


def grouped_preactivation(xyz: torch.Tensor, v: Optional[torch.Tensor], new_xyz: torch.Tensor,
                          w0x: torch.Tensor, b0: Optional[torch.Tensor], radius: float,
                          nsample: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """mlp0 over each ball, factored: v (mlp0's feature columns applied at
    the source points, plus its bias) gathered, plus the xyz columns w0x (3,
    C0) on the centred offsets; without features the xyz term plus b0 ->
    (B, M, S, C0). In bf16 the offsets and w0x are rounded to bf16 and each
    operation of the term rounds (the module doc)."""
    idx = ball_query(new_xyz, xyz, radius, nsample)
    gx = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if dtype == BF16:
        gx, w0x = gx.to(BF16), w0x.to(BF16)
    term = (gx[..., 0:1] * w0x[0] + gx[..., 1:2] * w0x[1]) + gx[..., 2:3] * w0x[2]
    if v is not None:
        return group_points(v, idx) + term
    return term if b0 is None else term + b0.to(term.dtype)


def ball_mlp_max(mlp: SharedMLP, xyz: torch.Tensor, features: Optional[torch.Tensor],
                 new_xyz: torch.Tensor, radius: float, nsample: int, sa_min_c0: int,
                 kernels_off: frozenset = frozenset()) -> torch.Tensor:
    """One ball-grouped scale: SharedMLP over each ball of centred xyz (and
    features), max over the ball -> (B, M, C_last)."""
    w0 = mlp.dense(0).weight  # (C0, 3 + C)
    b0 = mlp.dense(0).bias
    c0 = mlp.channels[0]
    dt = mlp.dtype
    gated = c0 >= sa_min_c0
    v = None
    if features is not None:
        v = product_bf16(features, w0[:, 3:]) if dt == BF16 else features @ w0[:, 3:].t()
        if b0 is not None:
            v = v + b0.to(v.dtype)
    w0x = w0[:, :3].t()
    trains_bn = mlp.training and mlp.use_bn
    if gated and not trains_bn and (mlp.training or "sa" not in kernels_off) and v is not None:
        mul0, add0 = mlp_affine0(mlp, v.device)
        sa = sa_ball_mlp_max_train if mlp.training else sa_ball_mlp_max
        return sa(xyz, new_xyz, v.contiguous(), w0x.contiguous(), mul0, add0,
                  mlp.folded_chain(1), radius, nsample)
    if gated and not mlp.training and "pool" not in kernels_off:
        mul0, add0 = mlp_affine0(mlp, xyz.device)
        weights = mlp.folded_chain(1)
        b, m = new_xyz.shape[:2]
        step = max(1, GROUPED_CHUNK_ELEMS // (m * nsample * c0))
        outs = []
        for lo in range(0, b, step):
            x = grouped_preactivation(xyz[lo:lo + step], None if v is None else v[lo:lo + step],
                                      new_xyz[lo:lo + step], w0x, b0, radius, nsample, dt)
            outs.append(grouped_mlp_max(x.reshape(-1, nsample, c0), mul0, add0, weights))
        return torch.cat(outs, 0).reshape(b, m, -1)
    x = grouped_preactivation(xyz, v, new_xyz, w0x, b0, radius, nsample, dt)
    x = torch.relu(mlp.norm(0, x))
    return mlp.layers_from(x, 1).amax(dim=2)


def mlp_affine0(mlp: SharedMLP, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mul0, add0) of mlp0's eval BN, ones and zeros without BN, contiguous."""
    if mlp.use_bn:
        return tuple(t.contiguous() for t in mlp.bn_affine(0))
    c0 = mlp.channels[0]
    return torch.ones(c0, device=device), torch.zeros(c0, device=device)


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (PointnetSAModuleMSG)."""

    def __init__(self, npoint: int, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], in_features: int, use_bn: bool = True,
                 sa_min_c0: int = SA_MIN_C0, kernels_off=frozenset(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        self.sa_min_c0 = sa_min_c0
        self.kernels_off = kernel_tags(kernels_off)
        for i, mlp in enumerate(mlps):
            setattr(self, f"mlp_scale{i}", SharedMLP(mlp, 3 + in_features, use_bn, dtype))
        self.out_channels = sum(m[-1] for m in mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]):
        idx = fps_or_identity(xyz, self.npoint)
        new_xyz = xyz if idx is None else gather_points(xyz, idx)
        outs = [ball_mlp_max(getattr(self, f"mlp_scale{i}"), xyz, features, new_xyz, r, ns,
                             self.sa_min_c0, self.kernels_off)
                for i, (r, ns) in enumerate(zip(self.radii, self.nsamples))]
        return new_xyz, torch.cat(outs, dim=-1)


class SAModule(nn.Module):
    """Single-scale set abstraction; npoint None groups all points into one
    ball of raw (uncentred) xyz (PointnetSAModule)."""

    def __init__(self, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], mlp: Sequence[int], in_features: int,
                 use_bn: bool = True, sa_min_c0: int = SA_MIN_C0, kernels_off=frozenset(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.sa_min_c0 = sa_min_c0
        self.kernels_off = kernel_tags(kernels_off)
        self.mlp = SharedMLP(mlp, 3 + in_features, use_bn, dtype)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]):
        if self.npoint is None:
            g = xyz if features is None else torch.cat([xyz, features], dim=-1)
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
            return new_xyz, self.mlp(g).amax(dim=1, keepdim=True)
        idx = fps_or_identity(xyz, self.npoint)
        new_xyz = xyz if idx is None else gather_points(xyz, idx)
        return new_xyz, ball_mlp_max(self.mlp, xyz, features, new_xyz, self.radius,
                                     self.nsample, self.sa_min_c0, self.kernels_off)


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation, concat with
    the skip features, SharedMLP."""

    def __init__(self, mlp: Sequence[int], in_channels: int, use_bn: bool = True,
                 kernels_off=frozenset(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = SharedMLP(mlp, in_channels, use_bn, dtype)
        self.kernels_off = kernel_tags(kernels_off)

    def forward(self, unknown, known, unknown_feats, known_feats):
        if (known is not None and unknown_feats is not None and not self.training
                and "fp" not in self.kernels_off):
            return fp_fused(unknown, known, known_feats.contiguous(), unknown_feats.contiguous(),
                            self.mlp.folded_chain(0))
        if known is not None:
            d, idx = three_nn(unknown, known)
            interp = three_interpolate(known_feats, idx, three_nn_interpolate_weights(d))
        else:
            interp = known_feats.expand(-1, unknown.shape[1], -1)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class Pointnet2MSG(nn.Module):
    """Multi-level MSG encoder + FP decoders (reference pointnet2_msg.py);
    the level count follows `npoints`."""

    def __init__(self, npoints: Sequence[int] = (4096, 1024, 256, 64),
                 radii: Sequence[Sequence[float]] = ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0),
                                                     (2.0, 4.0)),
                 nsamples: Sequence[Sequence[int]] = ((16, 32),) * 4,
                 mlps: Sequence[Sequence[Sequence[int]]] = (
                     ((16, 16, 32), (32, 32, 64)),
                     ((64, 64, 128), (64, 96, 128)),
                     ((128, 196, 256), (128, 196, 256)),
                     ((256, 256, 512), (256, 384, 512))),
                 fp_mlps: Sequence[Sequence[int]] = ((128, 128), (256, 256), (512, 512),
                                                     (512, 512)),
                 in_features: int = 0, use_bn: bool = True, sa_min_c0: int = SA_MIN_C0,
                 kernels_off=frozenset(), dtype: torch.dtype = torch.float32):
        super().__init__()
        levels = len(npoints)
        self.levels = levels
        feat = [in_features]
        for k in range(levels):
            sa = SAModuleMSG(npoints[k], radii[k], nsamples[k], mlps[k], feat[k], use_bn,
                             sa_min_c0, kernels_off, dtype)
            setattr(self, f"sa{k}", sa)
            feat.append(sa.out_channels)
        for i in range(levels - 1, -1, -1):
            known = feat[levels] if i == levels - 1 else fp_mlps[i + 1][-1]
            setattr(self, f"fp{i}", FPModule(fp_mlps[i], known + feat[i], use_bn, kernels_off,
                                             dtype))
        self.out_channels = fp_mlps[0][-1]

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None):
        l_xyz, l_feats = [xyz], [features]
        for k in range(self.levels):
            nx, nf = getattr(self, f"sa{k}")(l_xyz[k], l_feats[k])
            l_xyz.append(nx)
            l_feats.append(nf)
        for i in range(self.levels - 1, -1, -1):
            l_feats[i] = getattr(self, f"fp{i}")(l_xyz[i], l_xyz[i + 1], l_feats[i],
                                                 l_feats[i + 1])
        return l_xyz[0], l_feats[0]


def set_kernels_off(model: nn.Module, tags) -> None:
    """Route every PointNet++ module of a built model as ``kernels_off``
    would have at construction (a bench or smoke run switches routes on
    models it already holds)."""
    tags = kernel_tags(tags)
    for mod in model.modules():
        if isinstance(mod, (SAModuleMSG, SAModule, FPModule)):
            mod.kernels_off = tags
