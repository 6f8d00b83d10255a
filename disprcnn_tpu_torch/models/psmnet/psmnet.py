"""PSMNet-style iDispNet, eval and train forward (counterpart of
disprcnn_tpu/models/psmnet/psmnet.py; reference
modeling/psmnet/{stackhourglass.py, submodule.py}).

Siamese feature tower with SPP -> concat cost volume -> 3D conv trunk with
three stacked hourglasses -> classifier heads -> align-corners soft-argmin.
Canonical layouts: NCHW in the tower, NCDHW in the trunk. The JAX package's
TPU layout forms (W-packing of the tower, depth-packing of the trunk) are
layouts of these same convolutions and are not carried over.

Every module is built in eval mode, as the JAX modules default to
train=False; ``model.train()`` turns train mode on. Module and attribute
names keep the Flax names (``ConvBN_0``,
``BasicBlock_3``, ``dres2``, ``Conv_0``, ``BatchNorm_0`` ...) so the JAX
variables map one to one (utils/weights.py). Batch norms are plain eval
``nn.BatchNorm{2,3}d`` with eps 1e-5.

Kernels on the card (csrc/conv3d_tc.cu, csrc/cost_volume_tc.cu,
csrc/conv3d.cu, csrc/softargmin.cu), each conv with its BN, residual and
ReLU fused:
- the tower's 3x3 stride-1 undilated convs of 32 and 64 channels (the
  sites of the JAX package's W-packed kernel): the 2D conv (conv3d_tc.cu);
- the cost volume and its first conv (dres0_0): cost_volume_tc.cu;
- every stride-1 3x3x3 conv (the trunk at full resolution, the hourglass
  convs at 1/2 and 1/4), the hourglasses' stride-2 convs and their
  transposed convs: the tensor-core convs (conv3d_tc.cu);
- each classifier's 32 -> 1 conv: the Co = 1 form (conv3d.cu);
- the regression: the soft-argmin.
The tower's other convs (the stride-2 stem and downsampling, the 1x1
downsample and SPP convs, the 128-channel and dilated layers, lastconv)
are cuDNN calls, as the JAX package leaves them to XLA on the TPU.

Train mode (``self.training``, psmnet.py:529-579, :691-709, :962-1020):
every BatchNorm normalizes with the batch statistics as Flax does
(``batch_norm_train``); every stride-1 3x3x3 trunk conv (dres0_1,
dres1_*, each hourglass's ConvBN_1 and ConvBN_3, classif*_0) is the raw
conv of the train kernel (``conv3d_train``, differentiable), its BN,
residual and ReLU outside; the cost volume with its first conv, the
tower, the stride-2 and transposed convs, the one-channel classifiers
and the soft-argmin are plain differentiable PyTorch, as they are XLA in
the JAX package's training. ``forward`` then returns the deep-supervision
tuple (one disparity per hourglass).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cost_volume import build_cost_volume
from ...ops.cuda.conv3d import (CHANNELS, conv2d_bn, conv3d_bn, conv3d_train,
                                cost_volume_conv_bn, deconv3d_bn)
from ...ops.cuda.softargmin import interp_matrix_align_corners, softargmin, softargmin_plain
from ...parallel.mesh import sum_over_ranks_autograd
from ...parallel.multihost import process_count

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # Flax's: running = 0.9 * running + 0.1 * batch


def batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                     axis: int = 1) -> torch.Tensor:
    """Train-mode BN over every axis but the channel axis `axis`, as Flax's
    BatchNorm computes it: the biased variance E[x^2] - E[x]^2 (clipped at
    0) normalizes, and the running statistics take momentum 0.9 with that
    same biased variance (nn.BatchNorm's own train mode would store the
    unbiased one). The one implementation for both users: iDispNet's
    channels-first convs (axis 1) and PointNet++'s channels-last MLPs and
    RPN heads (axis -1, models/pointrcnn/pointnet2.py and rpn3d.py), whose
    statistics take every row, padded instances and repeated ball slots
    included, as JAX's do.

    With several ranks the statistics are the global batch's: E[x] and
    E[x^2] from the sums of x and x^2 over every rank's rows, through the
    autograd all-reduce, so that the gradient keeps the cross-rank terms;
    the running statistics then come out equal on every rank."""
    axis = axis % x.dim()
    dims = [d for d in range(x.dim()) if d != axis]
    if process_count() == 1:
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
    else:
        s = x.sum(dims)
        rows = torch.full_like(s, float(x.numel() // x.shape[axis]))
        sums = sum_over_ranks_autograd(torch.stack([s, (x * x).sum(dims), rows]))
        mean, mean_sq = sums[0] / sums[2], sums[1] / sums[2]
        var = (mean_sq - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var.detach(), alpha=1 - BN_MOMENTUM)
    shape = [1] * x.dim()
    shape[axis] = -1
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


def norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Batch statistics in train mode, running statistics in eval."""
    return batch_norm_train(bn, x) if bn.training else bn(x)


def _finish(y, relu: bool, residual):
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def fold_bn(bn: nn.modules.batchnorm._BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as (mul, add): mul = scale * rsqrt(var + eps), add = bias -
    mean * mul (psmnet.py:_fold_bn_affine)."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return mul, bn.bias - bn.running_mean * mul


class ConvBN(nn.Module):
    """kxk conv (no bias, padding dilation * (k // 2)) + eval BN; the
    residual joins before the ReLU. The 3x3 stride-1 undilated form of 32
    or 64 output channels is one call of the 2D conv kernel."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride, dilation * (kernel // 2),
                                dilation, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.fused = kernel == 3 and stride == 1 and dilation == 1 and cout in CHANNELS
        self.eval()

    def forward(self, x, relu: bool = False, residual=None):
        if self.fused and not self.training:
            return conv2d_bn(x, self.Conv_0.weight, *fold_bn(self.BatchNorm_0), residual, relu)
        return _finish(norm(self.BatchNorm_0, self.Conv_0(x)), relu, residual)


class BasicBlock(nn.Module):
    """PSMNet BasicBlock (submodule.py:40-57): no ReLU after the residual
    add; the downsample is a 1x1 conv + BN."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, planes, 3, stride, dilation)
        self.ConvBN_1 = ConvBN(planes, planes, 3, 1, dilation)
        if downsample:
            self.Conv_0 = nn.Conv2d(cin, planes, 1, stride, bias=False)
            self.BatchNorm_0 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.downsample = downsample
        self.eval()

    def forward(self, x):
        out = self.ConvBN_0(x, relu=True)
        sc = norm(self.BatchNorm_0, self.Conv_0(x)) if self.downsample else x
        return self.ConvBN_1(out, residual=sc)


def bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, H, W), align_corners=True, by the same matrix
    contractions as the JAX package."""
    mh = interp_matrix_align_corners(x.shape[2], out_hw[0], x.device, x.dtype)
    mw = interp_matrix_align_corners(x.shape[3], out_hw[1], x.device, x.dtype)
    x = torch.einsum("bchw,eh->bcew", x, mh)
    return torch.einsum("bchw,ew->bche", x, mw)


class FeatureExtraction(nn.Module):
    """Siamese tower -> 1/4-res 32-channel features (submodule.py:234-313)."""

    SPP_POOLS = (56, 32, 16, 8)
    # (planes, blocks, stride, dilation) of layer1..layer4
    LAYERS = ((32, 3, 1, 1), (64, 16, 2, 1), (128, 3, 1, 1), (128, 3, 1, 2))

    def __init__(self):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, 3, 2)
        self.ConvBN_1 = ConvBN(32, 32)
        self.ConvBN_2 = ConvBN(32, 32)
        blocks = []
        cin = 32
        for planes, n, stride, dilation in self.LAYERS:
            for i in range(n):
                s = stride if i == 0 else 1
                blocks.append(BasicBlock(cin, planes, s, dilation,
                                         downsample=i == 0 and (s != 1 or cin != planes)))
                cin = planes
        for i, block in enumerate(blocks):
            self.add_module(f"BasicBlock_{i}", block)
        self.n_blocks = len(blocks)
        self.raw_block = self.LAYERS[0][1] + self.LAYERS[1][1] - 1  # end of layer2
        for i in range(len(self.SPP_POOLS)):
            self.add_module(f"ConvBN_{3 + i}", ConvBN(128, 32, 1))
        self.ConvBN_7 = ConvBN(320, 128)
        self.Conv_0 = nn.Conv2d(128, 32, 1, bias=False)
        self.eval()

    def forward(self, x):
        x = self.ConvBN_0(x, relu=True)
        x = self.ConvBN_1(x, relu=True)
        x = self.ConvBN_2(x, relu=True)
        raw = None
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
            if i == self.raw_block:  # 1/4 res, 64 ch
                raw = x
        skip = x  # layer4, dilated
        h, w = skip.shape[-2:]
        spp = []
        for i, pool in enumerate(self.SPP_POOLS):
            p = min(pool, h)
            y = F.avg_pool2d(skip, p, p)
            y = getattr(self, f"ConvBN_{3 + i}")(y, relu=True)
            spp.append(bilinear_align_corners(y, (h, w)))
        # reference concat order: (raw, skip, branch4..branch1)
        x = torch.cat([raw, skip] + spp[::-1], dim=1)  # 320 ch
        x = self.ConvBN_7(x, relu=True)
        return self.Conv_0(x)


class ConvBN3d(nn.Module):
    """3x3x3 conv (no bias, padding 1, stride 1 or 2) + eval BN
    (+ residual, + ReLU): one call of the conv3d kernel. In train mode the
    conv is conv3d_train (stride 1) or a cuDNN conv (stride 2, the cost
    volume), then batch-stat BN, residual and ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv3d(cin, cout, 3, stride, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm3d(cout, eps=BN_EPS)
        self.stride = stride
        self.eval()

    def forward(self, x, relu: bool = False, residual=None):
        w = self.Conv_0.weight
        if self.training:
            y = conv3d_train(x, w) if self.stride == 1 else F.conv3d(x, w, stride=2, padding=1)
            return _finish(batch_norm_train(self.BatchNorm_0, y), relu, residual)
        mul, add = fold_bn(self.BatchNorm_0)
        return conv3d_bn(x, w, mul, add, residual, relu, self.stride)

    def cost_volume(self, left, right, mindisp4: int, maxdisp4: int, relu: bool = True):
        """This conv over the concat cost volume of (N, C, H, W) features,
        the volume built inside the kernel (in train mode, stored)."""
        if self.training:
            y = F.conv3d(build_cost_volume(left, right, mindisp4, maxdisp4),
                         self.Conv_0.weight, padding=1)
            return _finish(batch_norm_train(self.BatchNorm_0, y), relu, None)
        mul, add = fold_bn(self.BatchNorm_0)
        return cost_volume_conv_bn(left, right, self.Conv_0.weight, mul, add, mindisp4,
                                   maxdisp4, relu)


def _deconv(cin: int, cout: int) -> nn.ConvTranspose3d:
    # torch ConvTranspose3d(k=3, s=2, p=1, output_padding=1) doubles every
    # dim with (lo, hi) = (1, 2) effective padding, the flax padding
    # [(1, 2)] * 3 of the JAX package (its kernel is flipped in space:
    # utils/weights.py)
    return nn.ConvTranspose3d(cin, cout, 3, 2, 1, output_padding=1, bias=False)


class Hourglass(nn.Module):
    """Stacked-hourglass block (stackhourglass.py:8-52), canonical form."""

    def __init__(self, planes: int):
        super().__init__()
        p2 = planes * 2
        self.ConvBN_0 = ConvBN3d(planes, p2, 2)
        self.ConvBN_1 = ConvBN3d(p2, p2, 1)
        self.ConvBN_2 = ConvBN3d(p2, p2, 2)
        self.ConvBN_3 = ConvBN3d(p2, p2, 1)
        self.ConvTranspose_0 = _deconv(p2, p2)
        self.BatchNorm_0 = nn.BatchNorm3d(p2, eps=BN_EPS)
        self.ConvTranspose_1 = _deconv(p2, planes)
        self.BatchNorm_1 = nn.BatchNorm3d(planes, eps=BN_EPS)
        self.eval()

    def forward(self, x, presqu, postsqu, final_residual):
        out = self.ConvBN_0(x, relu=True)  # 1/2
        pre = self.ConvBN_1(out, relu=True, residual=postsqu)
        out = self.ConvBN_2(pre, relu=True)  # 1/4
        out = self.ConvBN_3(out, relu=True)
        skip = presqu if presqu is not None else pre
        if self.training:
            post = _finish(norm(self.BatchNorm_0, self.ConvTranspose_0(out)), True, skip)
            up2 = _finish(norm(self.BatchNorm_1, self.ConvTranspose_1(post)), False,
                          final_residual)
            return up2, pre, post
        post = deconv3d_bn(out, self.ConvTranspose_0.weight, *fold_bn(self.BatchNorm_0),
                           skip, relu=True)  # 1/2
        up2 = deconv3d_bn(post, self.ConvTranspose_1.weight, *fold_bn(self.BatchNorm_1),
                          final_residual)
        return up2, pre, post


class CostVolumeTrunk(nn.Module):
    """The 3D half of iDispNet, shared by PSMNet (over its tower's 1/4
    features) and DispModule (over pooled FPN features): the concat cost
    volume with its first conv (dres0_0), dres0_1, dres1_*, the stacked
    hourglasses dres2.., each hourglass's classifier (classif{k}_0, _1),
    and the regression. ``_build_trunk`` registers the modules under their
    Flax names on the subclass (after the subclass's own first modules, in
    the JAX creation order); ``_regress`` runs them."""

    def _build_trunk(self, maxdisp: int, mindisp: int, num_hourglass: int) -> None:
        self.maxdisp, self.mindisp = maxdisp, mindisp
        self.num_hourglass = num_hourglass
        self.dres0_0 = ConvBN3d(64, 32)
        self.dres0_1 = ConvBN3d(32, 32)
        self.dres1_0 = ConvBN3d(32, 32)
        self.dres1_1 = ConvBN3d(32, 32)
        for i in range(num_hourglass):
            self.add_module(f"dres{2 + i}", Hourglass(32))
            self.add_module(f"classif{i + 1}_0", ConvBN3d(32, 32))
            self.add_module(f"classif{i + 1}_1", nn.Conv3d(32, 1, 3, 1, 1, bias=False))

    def _regress(self, lf: torch.Tensor, rf: torch.Tensor, stride: int,
                 out_hw: Tuple[int, int]):
        """lf, rf (B, 32, h, w) features at 1/stride of the output -> (B, H,
        W) disparity over [mindisp, maxdisp), or in train mode the tuple of
        num_hourglass disparities (deep supervision, the last one the
        prediction). The volume spans [mindisp // stride, maxdisp //
        stride)."""
        x = self.dres0_0.cost_volume(lf.contiguous(), rf.contiguous(), self.mindisp // stride,
                                     self.maxdisp // stride, relu=True)
        x = self.dres0_1(x, relu=True)
        y = self.dres1_0(x, relu=True)
        cost0 = self.dres1_1(y, residual=x)

        # quirk kept from the reference: hourglass k >= 2 gets pre_1 as its
        # presqu and the previous post as its postsqu (stackhourglass.py:139-141)
        outs, pres, posts = [], [], []
        inp = cost0
        for i in range(self.num_hourglass):
            o, pre, post = getattr(self, f"dres{2 + i}")(
                inp, None if i == 0 else pres[0], None if i == 0 else posts[-1], cost0)
            outs.append(o)
            pres.append(pre)
            posts.append(post)
            inp = o

        costs = []
        for i, o in enumerate(outs):
            z = getattr(self, f"classif{i + 1}_0")(o, relu=True)
            wc = getattr(self, f"classif{i + 1}_1").weight
            if self.training:
                c = F.conv3d(z, wc, padding=1)
                costs.append(c if i == 0 else c + costs[-1])
            else:
                # the sum with the previous classifier's cost joins as the
                # conv's residual: the same single add (the identity affine
                # leaves v exact)
                costs.append(conv3d_bn(z, wc, residual=costs[-1] if i else None))
        if self.training:
            return tuple(softargmin_plain(c[:, 0], out_hw, self.mindisp, self.maxdisp)
                         for c in costs)
        return softargmin(costs[-1][:, 0], out_hw, self.mindisp, self.maxdisp)


class PSMNet(CostVolumeTrunk):
    """Full iDispNet: forward(left, right) -> (B, H, W) disparity in eval,
    the tuple of num_hourglass disparities (deep supervision, the last
    one the prediction) in train mode."""

    def __init__(self, maxdisp: int = 48, mindisp: int = -48, num_hourglass: int = 3):
        super().__init__()
        self.feature_extraction = FeatureExtraction()
        self._build_trunk(maxdisp, mindisp, num_hourglass)
        self.eval()

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        """left, right (B, 3, H, W) normalized crops -> (B, H, W), or in
        train mode a tuple of them."""
        b, _, h, w = left.shape
        both = self.feature_extraction(torch.cat([left, right], dim=0))
        return self._regress(both[:b], both[b:], 4, (h, w))
