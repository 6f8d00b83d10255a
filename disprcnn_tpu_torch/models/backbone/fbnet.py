"""FBNet mobile trunks (counterpart of disprcnn_tpu/models/backbone/fbnet.py;
reference modeling/backbone/{fbnet.py,fbnet_builder.py,fbnet_modeldef.py}).

``MODEL_ARCH`` is the reference's zoo of five archs, copied as data. The
builder keeps the reference's channel arithmetic: a block's output depth
is _get_divisible_by(int(c * scale), divisor, divisor), its expansion
depth _get_divisible_by(int(c_in * t), divisor, divisor) on the INPUT
depth, the 1x1 expansion conv exists even at t = 1, the depthwise conv
skips its BN and ReLU per DW_CONV_SKIP_{BN,RELU}, a negative stride is a
nearest upsample by |s| then stride 1, and the residual is taken where
the stride is 1 and the depths match. ``FBNet`` returns one feature a kept
("backbone") stage; ``stage_channels`` gives their depths without a
forward (the FPN is built from them).

Two things follow the JAX package rather than torch's defaults:
- padding: Flax's "SAME", which at stride 2 pads total = max((ceil(n/s) -
  1) s + k - n, 0) with total // 2 before and the rest after (on an even
  side a 3x3/2 conv pads (0, 1), where nn.Conv2d(padding=1) pads (1, 1));
- the norms: the JAX package calls FBNet without ``train``, so its
  BatchNorms always normalize by their running statistics, also in a train
  step. ``RunningBatchNorm2d`` does that in train mode too, its scale and
  bias trainable, its statistics never updated.

NCHW. Flax names: ``first``, ``xif{stage}_{block}`` with ``pw``/``dw``/
``pwl``, each a ConvBNRelu of ``conv`` and ``bn``. The kept stages of
every arch stride 2, 4, 8 and 16, while an FPN's anchors and poolers
assume the ResNet's 4-32: the JAX package's quirk, kept (ROADMAP C34).
"""
from __future__ import annotations

import copy
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# -- arch zoo (fbnet_modeldef.py, data) ---------------------------------------
MODEL_ARCH = {
    "default": {
        "block_op_type": [
            ["ir_k3"],
            ["ir_k3"] * 2,
            ["ir_k3"] * 3,
            ["ir_k3"] * 7,
            ["ir_k3"] * 4,  # bbox head
            ["ir_k3"] * 3,  # rpn
            ["ir_k3"] * 5,  # mask head
        ],
        "block_cfg": {
            "first": [32, 2],
            "stages": [
                [[1, 16, 1, 1]],
                [[6, 24, 2, 2]],
                [[6, 32, 3, 2]],
                [[6, 64, 4, 2], [6, 96, 3, 1]],
                [[4, 160, 1, 2], [6, 160, 2, 1], [6, 240, 1, 1]],
                [[6, 96, 3, 1]],
                [[4, 160, 1, 1], [6, 160, 3, 1], [3, 80, 1, -2]],
            ],
            "last": [0, 0.0],
            "backbone": [0, 1, 2, 3],
            "rpn": [5],
            "bbox": [4],
            "mask": [6],
        },
    },
    "xirb16d_dsmask": {
        "block_op_type": [
            ["ir_k3"],
            ["ir_k3"] * 2,
            ["ir_k3"] * 3,
            ["ir_k3"] * 7,
            ["ir_k3"] * 4,  # bbox head
            ["ir_k3"] * 5,  # mask head
            ["ir_k3"] * 3,  # rpn
        ],
        "block_cfg": {
            "first": [16, 2],
            "stages": [
                [[1, 16, 1, 1]],
                [[6, 32, 2, 2]],
                [[6, 48, 3, 2]],
                [[6, 96, 4, 2], [6, 128, 3, 1]],
                [[4, 128, 1, 2], [6, 128, 2, 1], [6, 160, 1, 1]],
                [[4, 128, 1, 2], [6, 128, 2, 1], [6, 128, 1, -2], [3, 64, 1, -2]],
                [[6, 128, 3, 1]],
            ],
            "last": [0, 0.0],
            "backbone": [0, 1, 2, 3],
            "rpn": [6],
            "bbox": [4],
            "mask": [5],
        },
    },
    "mobilenet_v2": {
        "block_op_type": [
            ["ir_k3"],
            ["ir_k3"] * 2,
            ["ir_k3"] * 3,
            ["ir_k3"] * 7,
            ["ir_k3"] * 4,
        ],
        "block_cfg": {
            "first": [32, 2],
            "stages": [
                [[1, 16, 1, 1]],
                [[6, 24, 2, 2]],
                [[6, 32, 3, 2]],
                [[6, 64, 4, 2], [6, 96, 3, 1]],
                [[6, 160, 3, 1], [6, 320, 1, 1]],
            ],
            "last": [0, 0.0],
            "backbone": [0, 1, 2, 3],
            "bbox": [4],
        },
    },
    "cham_v1a": {
        "block_op_type": [
            ["ir_k3"],
            ["ir_k7"] * 2,
            ["ir_k3"] * 5,
            ["ir_k5"] * 7 + ["ir_k3"] * 5,
            ["ir_k3"] * 5,  # bbox head
            ["ir_k3"] * 3,  # rpn
        ],
        "block_cfg": {
            "first": [32, 2],
            "stages": [
                [[1, 24, 1, 1]],
                [[4, 48, 2, 2]],
                [[7, 64, 5, 2]],
                [[12, 56, 7, 2], [8, 88, 5, 1]],
                [[7, 152, 4, 2], [10, 104, 1, 1]],
                [[8, 88, 3, 1]],
            ],
            "last": [0, 0.0],
            "backbone": [0, 1, 2, 3],
            "rpn": [5],
            "bbox": [4],
        },
    },
    "cham_v2": {
        "block_op_type": [
            ["ir_k3"],
            ["ir_k5"] * 4,
            ["ir_k7"] * 6,
            ["ir_k5"] * 3 + ["ir_k3"] * 6,
            ["ir_k3"] * 7,  # bbox head
            ["ir_k3"] * 1,  # rpn
        ],
        "block_cfg": {
            "first": [32, 2],
            "stages": [
                [[1, 24, 1, 1]],
                [[8, 32, 4, 2]],
                [[5, 48, 6, 2]],
                [[9, 56, 3, 2], [6, 56, 6, 1]],
                [[2, 160, 6, 2], [6, 112, 1, 1]],
                [[6, 56, 1, 1]],
            ],
            "last": [0, 0.0],
            "backbone": [0, 1, 2, 3],
            "rpn": [5],
            "bbox": [4],
        },
    },
}

_KERNEL_BY_OP = {"ir_k1": 1, "ir_k3": 3, "ir_k5": 5, "ir_k7": 7}


def _py2_round(x: float) -> float:
    return math.floor(x + 0.5) if x >= 0.0 else math.ceil(x - 0.5)


def _get_divisible_by(num, divisible_by, min_val) -> int:
    """fbnet_builder.py:30-35 — NOT the tf-style round_channels."""
    ret = int(num)
    if divisible_by > 0 and num % divisible_by != 0:
        ret = int((_py2_round(num / divisible_by) or min_val) * divisible_by)
    return ret


def expand_stage_cfg(stage_cfg):
    """[t, c, n, s] -> n copies with stride only on the first."""
    ret = []
    for block in stage_cfg:
        for idx in range(block[2]):
            cur = copy.deepcopy(block)
            cur[2] = 1
            cur[3] = 1 if idx >= 1 else cur[3]
            ret.append(cur)
    return ret


def unify_arch_def(arch_def):
    """-> flat block list [{stage_idx, block_idx, block, block_op_type}]
    + first/backbone/... keys hoisted (fbnet_builder.py:641-677)."""
    ret = {k: v for k, v in arch_def["block_cfg"].items() if k != "stages"}
    blocks = []
    op_types = arch_def["block_op_type"]
    for si, stage in enumerate(arch_def["block_cfg"]["stages"]):
        expanded = expand_stage_cfg(stage)
        if len(op_types[si]) != len(expanded):
            raise ValueError(f"stage {si}: {len(op_types[si])} op types for "
                             f"{len(expanded)} blocks")
        for bi, (blk, op) in enumerate(zip(expanded, op_types[si])):
            blocks.append(
                {"stage_idx": si, "block_idx": bi, "block": blk,
                 "block_op_type": op}
            )
    ret["stages"] = blocks
    return ret


def arch_table(arch: str = "default", arch_def: Optional[dict] = None) -> dict:
    """The unified arch (unify_arch_def) of a zoo name or an explicit table."""
    return unify_arch_def(arch_def if arch_def is not None else MODEL_ARCH[arch])


def _kept_stages(arch: dict):
    return arch.get("backbone", sorted({b["stage_idx"] for b in arch["stages"]}))


def stage_channels(arch: str = "default", scale_factor: float = 1.0, width_divisor: int = 1,
                   arch_def: Optional[dict] = None) -> Tuple[int, ...]:
    """The depth of each feature FBNet returns (its kept stages' last
    blocks), without building it."""
    table = arch_table(arch, arch_def)
    keep = _kept_stages(table)
    last = {}
    for b in table["stages"]:
        if b["stage_idx"] in keep:
            last[b["stage_idx"]] = _get_divisible_by(int(b["block"][1] * scale_factor),
                                                     width_divisor, width_divisor)
    return tuple(last[s] for s in sorted(last))


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """Flax/XLA "SAME" padding (before, after) of a side of n for kernel k at
    stride s."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class RunningBatchNorm2d(nn.BatchNorm2d):
    """Flax's BatchNorm with use_running_average: y = (x - mean) *
    (rsqrt(var + eps) * weight) + bias on the running statistics, in train
    mode as in eval (weight and bias train; the statistics never move)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class ConvBNRelu(nn.Module):
    """A bias-free conv with Flax's SAME padding, then BN and ReLU (each
    optional)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 use_bn: bool = True, use_relu: bool = True):
        super().__init__()
        self.kernel, self.stride, self.use_relu = kernel, stride, use_relu
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, groups=groups, bias=False)
        self.bn = RunningBatchNorm2d(cout) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (ht, hb), (wl, wr) = (same_pads(n, self.kernel, self.stride) for n in x.shape[-2:])
        if ht or hb or wl or wr:
            x = F.pad(x, (wl, wr, ht, hb))
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_relu else x


class IRFBlock(nn.Module):
    """Inverted residual (fbnet_builder.py:445-560)."""

    def __init__(self, cin: int, cout: int, expansion: int, stride: int, kernel: int = 3,
                 width_divisor: int = 1, dw_skip_bn: bool = True, dw_skip_relu: bool = True):
        super().__init__()
        mid = _get_divisible_by(int(cin * expansion), width_divisor, width_divisor)
        self.stride, self.residual = stride, stride == 1 and cin == cout
        self.pw = ConvBNRelu(cin, mid, 1)
        self.dw = (ConvBNRelu(mid, mid, kernel, stride=max(stride, 1), groups=mid,
                              use_bn=not dw_skip_bn, use_relu=not dw_skip_relu)
                   if kernel > 1 else None)
        self.pwl = ConvBNRelu(mid, cout, 1, use_relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw(x)
        if self.stride < 0:  # an upsampling stage (mask heads)
            y = F.interpolate(y, scale_factor=-self.stride, mode="nearest")
        if self.dw is not None:
            y = self.dw(y)
        y = self.pwl(y)
        return y + x if self.residual else y


class FBNet(nn.Module):
    """The mobile trunk -> one NCHW feature a kept stage. `arch` names a
    MODEL_ARCH entry (MODEL.FBNET.ARCH names); `arch_def` is an explicit
    table in its place (MODEL.FBNET.ARCH_DEF)."""

    def __init__(self, arch: str = "default", arch_def: Optional[dict] = None,
                 scale_factor: float = 1.0, width_divisor: int = 1, dw_skip_bn: bool = True,
                 dw_skip_relu: bool = True):
        super().__init__()
        table = arch_table(arch, arch_def)
        depth = lambda c: _get_divisible_by(int(c * scale_factor), width_divisor, width_divisor)
        first_c, first_s = table["first"][0], table["first"][1]
        cin = depth(first_c)
        self.first = ConvBNRelu(3, cin, 3, stride=first_s)
        keep = _kept_stages(table)
        self.blocks = []  # (name, stage)
        for b in table["stages"]:
            if b["stage_idx"] not in keep:
                continue
            t, c, _, s = b["block"]
            name = f"xif{b['stage_idx']}_{b['block_idx']}"
            self.add_module(name, IRFBlock(cin, depth(c), t, s,
                                           kernel=_KERNEL_BY_OP[b["block_op_type"]],
                                           width_divisor=width_divisor, dw_skip_bn=dw_skip_bn,
                                           dw_skip_relu=dw_skip_relu))
            self.blocks.append((name, b["stage_idx"]))
            cin = depth(c)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.first(x)
        outs, prev = [], None
        for name, stage in self.blocks:
            if prev is not None and stage != prev:
                outs.append(x)
            prev = stage
            x = getattr(self, name)(x)
        outs.append(x)
        return tuple(outs)
